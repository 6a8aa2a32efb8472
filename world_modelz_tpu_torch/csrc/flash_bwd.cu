// Dense flash attention, backward, for Hopper (sm_90a): a split pair of
// kernels, a query-centric dQ pass and a key-centric dK/dV pass.
//
// Replaces the stock Pallas TPU backward kernels that the custom_vjp of
// `flash_attention` runs for world_modelz_tpu/models/attention.py:
// _flash_dense_attention (:124): `_flash_attention_dq_kernel`
// (jax/experimental/pallas/ops/tpu/flash_attention.py:1146, pallas_call
// :1456) and `_flash_attention_dkv_kernel` (:796, pallas_call :1121).
//
// What it computes. q, k, v, o (the forward's output) and g (its
// cotangent) are (B, H, N, D) operands read through their strides; lse
// (the forward's log-sum-exp) and delta are (B, H, N) f32; dq, dk, dv are
// written (B, N, H, D)-contiguous in the input dtype. With s_ij = scale *
// q_i . k_j and p_ij = e^{s_ij - lse_i} over the real keys j < N:
//   pass 1, per query tile: delta_i = g_i . o_i, dq_i = scale * sum_j p_ij
//     (g_i . v_j - delta_i) k_j;
//   pass 2, per key tile, over every query tile: dv_j = sum_i p_ij g_i,
//     dk_j = scale * sum_i p_ij (g_i . v_j - delta_i) q_i.
// Queries and keys at or past N are masked, as the TPU wrapper's segment
// ids mask its padding.
//
// What bounds it on the H100. At the sparse trainer's shape (B=16, H=8,
// N=1024, D=64, bf16) pass 1 reads q, k, v, o, g and lse and writes dq and
// delta (~42 MB, ~13 us at 3.35 TB/s) against 6 B H N^2 D = 51.5 GFLOP (~52
// us at the bf16 tensor-core peak); pass 2 reads q, k, v, g, lse, delta and
// writes dk, dv (~50 MB, ~15 us) against 8 B H N^2 D = 68.7 GFLOP (~69 us):
// both bound by operations.
//
// Design. The tiling of flash_tile.cuh, as the forward: one block of 256
// threads per (64-row tile, h, b), CUDA-core f32 FMAs over f32 tiles in
// shared memory. Pass 1 holds its query tile and g tile, walks the key
// tiles and accumulates dq in registers; pass 2 holds its key tile and v
// tile, walks every query tile and accumulates dk and dv in registers, so
// no block adds into another's output: no atomics, and two launches are
// bitwise equal. P and dS go through shared memory into the products.
// Tensor-core products are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

#include "flash_tile.cuh"

namespace {

using namespace wmz::flash;

// Pass 1: dq and delta.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ g, const float* __restrict__ lse,
                    T* __restrict__ dq, float* __restrict__ delta, Strides sq,
                    Strides sk, Strides sv, Strides so, Strides sg, int H,
                    int N, float scale) {
  constexpr int kC = D / kTx;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Gs = Qs + kTile * (D + 1);
  float* Ks = Gs + kTile * (D + 1);
  float* Vs = Ks + kTile * (D + 1);
  float* Ss = Vs + kTile * (D + 1);  // 64 x kSLd: dS
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / kTx, tx = threadIdx.x % kTx;

  load_tile<T, D>(Qs, q, sq, b, h, q0, N);
  load_tile<T, D>(Gs, g, sg, b, h, q0, N);
  __syncthreads();
  // this thread's rows: lse, and delta = g . o (g from the tile, o read
  // once from device memory); 0 for rows at or past N (not stored)
  float row_lse[kRows], row_delta[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty * kRows + i, n = q0 + r;
    float part = 0.f;
    if (n < N) {
      const T* orow = o + b * so.b + h * so.h + n * so.n + tx;
#pragma unroll
      for (int c = 0; c < kC; ++c)
        part = fmaf(Gs[r * (D + 1) + tx + c * kTx], to_float(orow[c * kTx]), part);
    }
    row_delta[i] = row_sum(part);
    row_lse[i] = n < N ? lse[((long long)b * H + h) * N + n] : 0.f;
  }

  float acc[kRows][kC];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < N; k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(Ks, k, sk, b, h, k0, N);
    load_tile<T, D>(Vs, v, sv, b, h, k0, N);
    __syncthreads();
    float s[kRows][kCols], dp[kRows][kCols];
    tile_dots<D>(Qs, Ks, s);
    tile_dots<D>(Gs, Vs, dp);
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = k0 + tx + kTx * j < N
                            ? expf(fmaf(s[i][j], scale, -row_lse[i]))
                            : 0.f;
        Ss[(ty * kRows + i) * kSLd + tx + kTx * j] = p * (dp[i][j] - row_delta[i]);
      }
    __syncthreads();
    tile_product<D>(Ss, Ks, acc);
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int n = q0 + ty * kRows + i;
    if (n >= N) continue;
    T* row = dq + (((long long)b * N + n) * H + h) * D + tx;
#pragma unroll
    for (int c = 0; c < kC; ++c) row[c * kTx] = from_float<T>(acc[i][c] * scale);
    if (tx == 0) delta[((long long)b * H + h) * N + n] = row_delta[i];
  }
}

// Pass 2: dk and dv from pass 1's delta and the forward's lse.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ g,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, Strides sq, Strides sk, Strides sv,
                     Strides sg, int H, int N, float scale) {
  constexpr int kC = D / kTx;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kTile * (D + 1);
  float* Qs = Vs + kTile * (D + 1);
  float* Gs = Qs + kTile * (D + 1);
  float* Ps = Gs + kTile * (D + 1);  // 64 x kSLd: P^T (keys x queries)
  float* Ss = Ps + kTile * kSLd;     // 64 x kSLd: dS^T
  float* Ls = Ss + kTile * kSLd;     // the query tile's lse
  float* Ds = Ls + kTile;            // and delta
  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / kTx, tx = threadIdx.x % kTx;
  const float* lse_bh = lse + ((long long)b * H + h) * N;
  const float* delta_bh = delta + ((long long)b * H + h) * N;

  load_tile<T, D>(Ks, k, sk, b, h, k0, N);
  load_tile<T, D>(Vs, v, sv, b, h, k0, N);
  float dka[kRows][kC], dva[kRows][kC];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < kC; ++c) dka[i][c] = dva[i][c] = 0.f;

  for (int q0 = 0; q0 < N; q0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(Qs, q, sq, b, h, q0, N);
    load_tile<T, D>(Gs, g, sg, b, h, q0, N);
    if (threadIdx.x < kTile) {
      const int n = q0 + threadIdx.x;
      Ls[threadIdx.x] = n < N ? lse_bh[n] : 0.f;
      Ds[threadIdx.x] = n < N ? delta_bh[n] : 0.f;
    }
    __syncthreads();
    // rows: this block's keys; columns: the tile's queries
    float s[kRows][kCols], dp[kRows][kCols];
    tile_dots<D>(Ks, Qs, s);
    tile_dots<D>(Vs, Gs, dp);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = tx + kTx * j;
      const bool real = q0 + col < N;
      const float l = Ls[col], d = Ds[col];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float p = real ? expf(fmaf(s[i][j], scale, -l)) : 0.f;
        Ps[(ty * kRows + i) * kSLd + col] = p;
        Ss[(ty * kRows + i) * kSLd + col] = p * (dp[i][j] - d);
      }
    }
    __syncthreads();
    tile_product<D>(Ps, Gs, dva);
    tile_product<D>(Ss, Qs, dka);
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int n = k0 + ty * kRows + i;
    if (n >= N) continue;
    const long long o = (((long long)b * N + n) * H + h) * D + tx;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      dk[o + c * kTx] = from_float<T>(dka[i][c] * scale);
      dv[o + c * kTx] = from_float<T>(dva[i][c]);
    }
  }
}

// the dynamic shared memory of a kernel, set before each launch: above 48
// KB a kernel must opt in
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

Strides at(const long long* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* g, const float* lse,
                      void* dq, float* delta, const long long* st, int B,
                      int H, int N, float scale, cudaStream_t stream) {
  const size_t bytes = smem_bytes<D>(4, 1, 0);
  auto kernel = flash_bwd_dq_kernel<T, D>;
  const cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid_for(B, H, N), kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(g), lse, static_cast<T*>(dq), delta, at(st, 0),
      at(st, 1), at(st, 2), at(st, 3), at(st, 4), H, N, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* g, const float* lse, const float* delta,
                       void* dk, void* dv, const long long* st, int B, int H,
                       int N, float scale, cudaStream_t stream) {
  const size_t bytes = smem_bytes<D>(4, 2, 2);
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  const cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid_for(B, H, N), kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), at(st, 0), at(st, 1),
      at(st, 2), at(st, 3), H, N, scale);
  return cudaGetLastError();
}

}  // namespace

// strides: int64 [15], the b, h, n element strides of q, k, v, o, g.
// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t.
extern "C" int wmz_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* o, const void* g, const void* lse,
                                void* dq, void* delta,
                                const long long* strides, int B, int H,
                                int N, int D, float scale, int dtype,
                                void* stream) {
  if (wmz::flash::bad_head_size(D) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ls = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
#define WMZ_FLASH_DQ(TT, DD)                                                \
  return (int)launch_dq<TT, DD>(q, k, v, o, g, ls, dq, dl, strides, B, H, N, \
                                scale, st)
  if (dtype == 0) {
    if (D == 64) WMZ_FLASH_DQ(float, 64);
    WMZ_FLASH_DQ(float, 128);
  }
  if (D == 64) WMZ_FLASH_DQ(__nv_bfloat16, 64);
  WMZ_FLASH_DQ(__nv_bfloat16, 128);
#undef WMZ_FLASH_DQ
}

// strides: int64 [12], the b, h, n element strides of q, k, v, g.
extern "C" int wmz_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* g, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 const long long* strides, int B, int H,
                                 int N, int D, float scale, int dtype,
                                 void* stream) {
  if (wmz::flash::bad_head_size(D) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
#define WMZ_FLASH_DKV(TT, DD)                                                  \
  return (int)launch_dkv<TT, DD>(q, k, v, g, ls, dl, dk, dv, strides, B, H, N, \
                                 scale, st)
  if (dtype == 0) {
    if (D == 64) WMZ_FLASH_DKV(float, 64);
    WMZ_FLASH_DKV(float, 128);
  }
  if (D == 64) WMZ_FLASH_DKV(__nv_bfloat16, 64);
  WMZ_FLASH_DKV(__nv_bfloat16, 128);
#undef WMZ_FLASH_DKV
}

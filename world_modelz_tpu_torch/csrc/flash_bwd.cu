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
//   pass 1, per query tile: delta_i = g_i . o_i, dq_i = sum_j ds_ij k_j
//     with ds_ij = scale * p_ij (g_i . v_j - delta_i);
//   pass 2, per key tile, over every query tile: dv_j = sum_i p_ij g_i,
//     dk_j = sum_i ds_ij q_i.
// In bf16, p (for dv) and ds (for dq and dk) are rounded to bf16 before
// their products, as the TPU kernels cast them to the operand dtype
// (flash_attention.py:900, :918, :1258); every sum is f32. Queries and keys
// at or past N are masked, as the TPU wrapper's segment ids mask its
// padding.
//
// What bounds it on the H100. At the sparse trainer's shape (B=16, H=8,
// N=1024, D=64, bf16) pass 1 reads q, k, v, o, g and lse and writes dq and
// delta (~102 MB, ~30 us at 3.35 TB/s) against 6 B H N^2 D = 51.5 GFLOP
// (~52 us at the bf16 tensor-core peak); pass 2 reads q, k, v, g, lse,
// delta and writes dk, dv (~102 MB) against 8 B H N^2 D = 68.7 GFLOP (~69
// us): both bound by operations, so the products belong on the tensor
// cores.
//
// Design. bf16 (D = 64, 128): flash_mma.cuh's tiling. A block of 4 warps
// owns 64 queries (pass 1) or 64 keys (pass 2) of one (b, h), 16 rows per
// warp, and walks the other side's tiles with the next tile's cp.async
// copies in flight while the current one is multiplied. Every product is
// an mma.sync m16n8k16 with f32 sums in registers: S = Q K^T and dP = G
// V^T, then P and dS in registers, rounded to bf16, as the A fragments of
// dQ += dS K (pass 1) or dV += P^T G and dK += dS^T Q (pass 2); P and dS
// never touch shared memory. Pass 2 walks 64 queries a step at D = 64 and
// 32 at D = 128, so that its two 16 x D sums and the two score tiles fit
// in registers. f32: flash_tile.cuh's CUDA-core tiling (one block of 256
// threads per 64-row tile, f32 FMAs over f32 tiles in shared memory, P and
// dS staged through shared memory), which keeps f32 arithmetic end to end.
// Either way no block adds into another's output: no atomics, and two
// launches are bitwise equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

#include "bd_mask.cuh"
#include "flash_mma.cuh"
#include "flash_tile.cuh"
#include "launch_log.cuh"

namespace {

using namespace wmz::flash;
namespace mma = wmz::mma;

// ----------------------------------------------------------------- f32
// The CUDA-core pair (flash_tile.cuh), instantiated for float.

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

// ---------------------------------------------------------------- bf16
// The tensor-core pair (flash_mma.cuh): kWarps warps own 16 kWarps rows of
// one side; pass 2 walks 64 queries a step at D = 64 and 32 at D = 128.

using mma::bf16;
constexpr int kWarps = 4;
template <int D>
constexpr int dkv_cols() {
  return D == 64 ? 64 : 32;
}

// Pass 1 on the tensor cores: dq and delta for 16 kWarps queries, walking
// the keys 64 at a time.
template <int D>
__global__ void __launch_bounds__(32 * kWarps)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ o,
                        const bf16* __restrict__ g, const float* __restrict__ lse,
                        bf16* __restrict__ dq, float* __restrict__ delta, Strides sq,
                        Strides sk, Strides sv, Strides so, Strides sg, int H, int N,
                        float scale) {
  constexpr int kOwn = 16 * kWarps, kCols = 64, L = D + mma::kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Gs = Qs + kOwn * L;
  bf16* KV = Gs + kOwn * L;  // two stages of (K, V), kCols rows each
  const int q0 = blockIdx.x * kOwn, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, t = lane & 3;
  const long long bh = (long long)b * H + h;
  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;
  const bf16* gb = g + b * sg.b + h * sg.h;
  const bf16* ob = o + b * so.b + h * so.h;

  mma::load_rows_async<D, kOwn>(Qs, qb, sq.n, q0, N);
  mma::load_rows_async<D, kOwn>(Gs, gb, sg.n, q0, N);
  mma::load_rows_async<D, kCols>(KV, kb, sk.n, 0, N);
  mma::load_rows_async<D, kCols>(KV + kCols * L, vb, sv.n, 0, N);
  mma::cp_async_commit();

  // delta = g . o in f32 (the TPU's di, flash_attention.py:273) while the
  // tiles arrive: lanes 2 r and 2 r + 1 of warp w sum the even and odd
  // 16-byte chunks of query 16 w + r
  float part = 0.f;
  {
    const int n = q0 + 16 * warp + (lane >> 1);
    if (n < N) {
      const bf16* grow = gb + n * sg.n;
      const bf16* orow = ob + n * so.n;
#pragma unroll
      for (int c = (lane & 1) * 8; c < D; c += 16) {
        const uint4 gv = *reinterpret_cast<const uint4*>(grow + c);
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
        const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 gf = __bfloat1622float2(g2[e]), of = __bfloat1622float2(o2[e]);
          part = fmaf(gf.x, of.x, part);
          part = fmaf(gf.y, of.y, part);
        }
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if ((lane & 1) == 0 && n < N) delta[bh * N + n] = part;
  }
  // this lane's rows gr and gr + 8: delta, and lse times log2 e
  const float scale_log2 = scale * mma::kLog2e;
  float row_delta[2], row_lse[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row_delta[i] = __shfl_sync(0xffffffffu, part, 2 * (gr + 8 * i));
    const int n = q0 + 16 * warp + gr + 8 * i;
    row_lse[i] = n < N ? lse[bh * N + n] * mma::kLog2e : 0.f;
  }

  float acc[D / 8][4];
  mma::zero<D / 8>(acc);
  const int steps = (N + kCols - 1) / kCols;
  for (int it = 0; it < steps; ++it) {
    if (it + 1 < steps) {  // the next K, V tiles into the other stage
      bf16* next = KV + ((it + 1) & 1) * 2 * kCols * L;
      mma::load_rows_async<D, kCols>(next, kb, sk.n, (it + 1) * kCols, N);
      mma::load_rows_async<D, kCols>(next + kCols * L, vb, sv.n, (it + 1) * kCols, N);
    }
    mma::cp_async_commit();
    mma::cp_async_wait<1>();
    __syncthreads();
    const bf16* Ks = KV + (it & 1) * 2 * kCols * L;
    const bf16* Vs = Ks + kCols * L;
    float s[kCols / 8][4], dp[kCols / 8][4];
    mma::warp_dots<D, kCols>(Qs + 16 * warp * L, Ks, s);
    mma::warp_dots<D, kCols>(Gs + 16 * warp * L, Vs, dp);
    const int k0 = it * kCols;
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float p = k0 + 8 * j + 2 * t + (e & 1) < N
                            ? exp2f(fmaf(s[j][e], scale_log2, -row_lse[i]))
                            : 0.f;
        s[j][e] = (dp[j][e] - row_delta[i]) * p * scale;  // ds, scaled
      }
    uint32_t ds[kCols / 16][4];  // rounded to bf16 (flash_attention.py:1258)
    mma::to_a_frags<kCols>(s, ds);
    mma::warp_product<D, kCols>(ds, Ks, acc);
    __syncthreads();  // every warp is done with this stage before its refill
  }
  mma::store_rows<D>(acc, dq + ((long long)b * N * H + h) * D, (long long)H * D,
                     q0 + 16 * warp, N);
}

// Pass 2 on the tensor cores: dk and dv for 16 kWarps keys, walking the
// queries kCols at a time with their lse and delta.
template <int D, int kCols>
__global__ void __launch_bounds__(32 * kWarps)
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ g,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, Strides sq,
                         Strides sk, Strides sv, Strides sg, int H, int N, float scale) {
  constexpr int kOwn = 16 * kWarps, L = D + mma::kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kOwn * L;
  bf16* QG = Vs + kOwn * L;  // two stages of (Q, G), kCols rows each
  float* stats = reinterpret_cast<float*>(QG + 4 * kCols * L);  // two of (lse, delta)
  const int k0 = blockIdx.x * kOwn, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const long long bh = (long long)b * H + h;
  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* gb = g + b * sg.b + h * sg.h;
  const float* lse_bh = lse + bh * N;
  const float* delta_bh = delta + bh * N;

  mma::load_rows_async<D, kOwn>(Ks, k + b * sk.b + h * sk.h, sk.n, k0, N);
  mma::load_rows_async<D, kOwn>(Vs, v + b * sv.b + h * sv.h, sv.n, k0, N);
  mma::load_rows_async<D, kCols>(QG, qb, sq.n, 0, N);
  mma::load_rows_async<D, kCols>(QG + kCols * L, gb, sg.n, 0, N);
  mma::load_vec_async<kCols>(stats, lse_bh, 0, N);
  mma::load_vec_async<kCols>(stats + kCols, delta_bh, 0, N);
  mma::cp_async_commit();

  const float scale_log2 = scale * mma::kLog2e;
  float dka[D / 8][4], dva[D / 8][4];
  mma::zero<D / 8>(dka);
  mma::zero<D / 8>(dva);
  const int steps = (N + kCols - 1) / kCols;
  for (int it = 0; it < steps; ++it) {
    if (it + 1 < steps) {  // the next Q, G tiles and their stats
      const int s1 = (it + 1) & 1, q1 = (it + 1) * kCols;
      bf16* next = QG + s1 * 2 * kCols * L;
      mma::load_rows_async<D, kCols>(next, qb, sq.n, q1, N);
      mma::load_rows_async<D, kCols>(next + kCols * L, gb, sg.n, q1, N);
      mma::load_vec_async<kCols>(stats + s1 * 2 * kCols, lse_bh, q1, N);
      mma::load_vec_async<kCols>(stats + s1 * 2 * kCols + kCols, delta_bh, q1, N);
    }
    mma::cp_async_commit();
    mma::cp_async_wait<1>();
    __syncthreads();
    const bf16* Qs = QG + (it & 1) * 2 * kCols * L;
    const bf16* Gs = Qs + kCols * L;
    const float* Ls = stats + (it & 1) * 2 * kCols;
    const float* Ds = Ls + kCols;
    // rows: this warp's keys; columns: the step's queries
    float s[kCols / 8][4], dp[kCols / 8][4];
    mma::warp_dots<D, kCols>(Ks + 16 * warp * L, Qs, s);
    mma::warp_dots<D, kCols>(Vs + 16 * warp * L, Gs, dp);
    const int q0 = it * kCols;
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1);
        const float p = q0 + col < N
                            ? exp2f(fmaf(s[j][e], scale_log2, -Ls[col] * mma::kLog2e))
                            : 0.f;
        s[j][e] = p;
        dp[j][e] = (dp[j][e] - Ds[col]) * p * scale;  // ds, scaled
      }
    uint32_t a[kCols / 16][4];
    mma::to_a_frags<kCols>(s, a);  // P^T in bf16 (flash_attention.py:900)
    mma::warp_product<D, kCols>(a, Gs, dva);
    mma::to_a_frags<kCols>(dp, a);  // dS^T in bf16 (:918)
    mma::warp_product<D, kCols>(a, Qs, dka);
    __syncthreads();  // every warp is done with this stage before its refill
  }
  const long long out = ((long long)b * N * H + h) * D;
  mma::store_rows<D>(dka, dk + out, (long long)H * D, k0 + 16 * warp, N);
  mma::store_rows<D>(dva, dv + out, (long long)H * D, k0 + 16 * warp, N);
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
  wmz::note_launch(kernel);
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
  wmz::note_launch(kernel);
  kernel<<<grid_for(B, H, N), kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), at(st, 0), at(st, 1),
      at(st, 2), at(st, 3), H, N, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_mma(const void* q, const void* k, const void* v,
                          const void* o, const void* g, const float* lse,
                          void* dq, float* delta, const long long* st, int B,
                          int H, int N, float scale, cudaStream_t stream) {
  constexpr int kOwn = 16 * kWarps;
  const size_t bytes = mma::tile_bytes<D>(2 * kOwn + 4 * 64);
  auto kernel = flash_bwd_dq_mma_kernel<D>;
  const cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((N + kOwn - 1) / kOwn), (unsigned)H, (unsigned)B);
  wmz::note_launch(kernel);
  kernel<<<grid, 32 * kWarps, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(o),
      static_cast<const bf16*>(g), lse, static_cast<bf16*>(dq), delta, at(st, 0),
      at(st, 1), at(st, 2), at(st, 3), at(st, 4), H, N, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_mma(const void* q, const void* k, const void* v,
                           const void* g, const float* lse, const float* delta,
                           void* dk, void* dv, const long long* st, int B, int H,
                           int N, float scale, cudaStream_t stream) {
  constexpr int kOwn = 16 * kWarps, C = dkv_cols<D>();
  const size_t bytes = mma::tile_bytes<D>(2 * kOwn + 4 * C) + 4 * C * sizeof(float);
  auto kernel = flash_bwd_dkv_mma_kernel<D, C>;
  const cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((N + kOwn - 1) / kOwn), (unsigned)H, (unsigned)B);
  wmz::note_launch(kernel);
  kernel<<<grid, 32 * kWarps, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(g), lse, delta,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), at(st, 0), at(st, 1),
      at(st, 2), at(st, 3), H, N, scale);
  return cudaGetLastError();
}


// ----------------------------------------------- bf16, block diffusion
// `bdflash_bwd_dq_kernel`, `bdflash_bwd_dkv_kernel`: the backward pair of
// flash_fwd.cu's bdflash_fwd_kernel (GQA under the block-diffusion mask,
// bd_mask.cuh; no TPU kernel has this form). The math and the rounding are
// the bf16 pair's above (P and dS to bf16 before their products, f32
// sums); each walks only the tiles the mask leaves and evaluates the
// predicate in the masked ones. Pass 1 owns 64 queries of one query head
// and reads K and V of its KV head. Pass 2 owns 64 keys of one KV head and
// walks, for each of the group's query heads in turn, the query tiles
// that read its keys, 32 queries a step: dK and dV are summed over the
// group in registers, with no atomics. Bound at the SDAR cell's shape:
// 6 D and 8 D allowed pairs, ~3.4 and ~4.5 ms a layer at the bf16 peak.

template <int D>
__global__ void __launch_bounds__(32 * kWarps)
bdflash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ o,
                      const bf16* __restrict__ g, const float* __restrict__ lse,
                      bf16* __restrict__ dq, float* __restrict__ delta, Strides sq, Strides sk,
                      Strides sv, Strides so, Strides sg, int H, int group, int N, int L, int bs,
                      float scale) {
  constexpr int kOwn = 16 * kWarps, kCols = wmz::bd::kTile, Lp = D + mma::kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Gs = Qs + kOwn * Lp;
  bf16* KV = Gs + kOwn * Lp;  // two stages of (K, V), kCols rows each
  const int q0 = blockIdx.x * kOwn, h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, t = lane & 3;
  const long long bh = (long long)b * H + h;
  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* kb = k + b * sk.b + hk * sk.h;
  const bf16* vb = v + b * sv.b + hk * sv.h;
  const bf16* gb = g + b * sg.b + h * sg.h;
  const bf16* ob = o + b * so.b + h * so.h;
  const int steps = wmz::bd::q_steps(q0, L);

  mma::load_rows_async<D, kOwn>(Qs, qb, sq.n, q0, N);
  mma::load_rows_async<D, kOwn>(Gs, gb, sg.n, q0, N);
  mma::load_rows_async<D, kCols>(KV, kb, sk.n, wmz::bd::q_step_key(q0, L, 0), N);
  mma::load_rows_async<D, kCols>(KV + kCols * Lp, vb, sv.n, wmz::bd::q_step_key(q0, L, 0), N);
  mma::cp_async_commit();

  // delta = g . o in f32 while the tiles arrive (as flash_bwd_dq_mma_kernel)
  float part = 0.f;
  {
    const int n = q0 + 16 * warp + (lane >> 1);
    const bf16* grow = gb + n * sg.n;
    const bf16* orow = ob + n * so.n;
#pragma unroll
    for (int c = (lane & 1) * 8; c < D; c += 16) {
      const uint4 gv = *reinterpret_cast<const uint4*>(grow + c);
      const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
      const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 gf = __bfloat1622float2(g2[e]), of = __bfloat1622float2(o2[e]);
        part = fmaf(gf.x, of.x, part);
        part = fmaf(gf.y, of.y, part);
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if ((lane & 1) == 0) delta[bh * N + n] = part;
  }
  const float scale_log2 = scale * mma::kLog2e;
  const int row0 = q0 + 16 * warp + gr;
  float row_delta[2], row_lse[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row_delta[i] = __shfl_sync(0xffffffffu, part, 2 * (gr + 8 * i));
    row_lse[i] = lse[bh * N + row0 + 8 * i] * mma::kLog2e;
  }

  float acc[D / 8][4];
  mma::zero<D / 8>(acc);
  for (int it = 0; it < steps; ++it) {
    if (it + 1 < steps) {  // the next K, V tiles into the other stage
      bf16* next = KV + ((it + 1) & 1) * 2 * kCols * Lp;
      const int k1 = wmz::bd::q_step_key(q0, L, it + 1);
      mma::load_rows_async<D, kCols>(next, kb, sk.n, k1, N);
      mma::load_rows_async<D, kCols>(next + kCols * Lp, vb, sv.n, k1, N);
    }
    mma::cp_async_commit();
    mma::cp_async_wait<1>();
    __syncthreads();
    const bf16* Ks = KV + (it & 1) * 2 * kCols * Lp;
    const bf16* Vs = Ks + kCols * Lp;
    float s[kCols / 8][4], dp[kCols / 8][4];
    mma::warp_dots<D, kCols>(Qs + 16 * warp * Lp, Ks, s);
    mma::warp_dots<D, kCols>(Gs + 16 * warp * Lp, Vs, dp);
    const int k0 = wmz::bd::q_step_key(q0, L, it);
    const bool masked = wmz::bd::q_step_masked(q0, L, it);
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float p = !masked || wmz::bd::allowed(row0 + 8 * i, k0 + 8 * j + 2 * t + (e & 1),
                                                    L, bs)
                            ? exp2f(fmaf(s[j][e], scale_log2, -row_lse[i]))
                            : 0.f;
        s[j][e] = (dp[j][e] - row_delta[i]) * p * scale;  // ds, scaled
      }
    uint32_t ds[kCols / 16][4];
    mma::to_a_frags<kCols>(s, ds);
    mma::warp_product<D, kCols>(ds, Ks, acc);
    __syncthreads();  // every warp is done with this stage before its refill
  }
  mma::store_rows<D>(acc, dq + ((long long)b * N * H + h) * D, (long long)H * D,
                     q0 + 16 * warp, N);
}

template <int D, int kCols>
__global__ void __launch_bounds__(32 * kWarps)
bdflash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ g,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       bf16* __restrict__ dk, bf16* __restrict__ dv, Strides sq, Strides sk,
                       Strides sv, Strides sg, int Hkv, int group, int N, int L, int bs,
                       float scale) {
  constexpr int kOwn = 16 * kWarps, Lp = D + mma::kPad, kHalves = wmz::bd::kTile / kCols;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kOwn * Lp;
  bf16* QG = Vs + kOwn * Lp;  // two stages of (Q, G), kCols rows each
  float* stats = reinterpret_cast<float*>(QG + 4 * kCols * Lp);  // two of (lse, delta)
  const int k0 = blockIdx.x * kOwn, hk = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3, gr = lane >> 2;
  const int H = Hkv * group, per_head = wmz::bd::k_steps(k0, L) * kHalves;
  const int steps = group * per_head;
  // step i: query head hk group + i / per_head, queries from q_of(i)
  auto q_of = [&](int i) {
    const int r = i % per_head;
    return wmz::bd::k_step_query(k0, L, r / kHalves) + (r % kHalves) * kCols;
  };
  auto issue = [&](int i) {
    const int s1 = i & 1, h = hk * group + i / per_head, q1 = q_of(i);
    const long long bh = (long long)b * H + h;
    bf16* next = QG + s1 * 2 * kCols * Lp;
    mma::load_rows_async<D, kCols>(next, q + b * sq.b + h * sq.h, sq.n, q1, N);
    mma::load_rows_async<D, kCols>(next + kCols * Lp, g + b * sg.b + h * sg.h, sg.n, q1, N);
    mma::load_vec_async<kCols>(stats + s1 * 2 * kCols, lse + bh * N, q1, N);
    mma::load_vec_async<kCols>(stats + s1 * 2 * kCols + kCols, delta + bh * N, q1, N);
  };

  mma::load_rows_async<D, kOwn>(Ks, k + b * sk.b + hk * sk.h, sk.n, k0, N);
  mma::load_rows_async<D, kOwn>(Vs, v + b * sv.b + hk * sv.h, sv.n, k0, N);
  issue(0);
  mma::cp_async_commit();

  const float scale_log2 = scale * mma::kLog2e;
  const int key0 = k0 + 16 * warp + gr;  // this lane's keys key0, key0 + 8
  float dka[D / 8][4], dva[D / 8][4];
  mma::zero<D / 8>(dka);
  mma::zero<D / 8>(dva);
  for (int it = 0; it < steps; ++it) {
    if (it + 1 < steps) issue(it + 1);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();
    __syncthreads();
    const bf16* Qs = QG + (it & 1) * 2 * kCols * Lp;
    const bf16* Gs = Qs + kCols * Lp;
    const float* Ls = stats + (it & 1) * 2 * kCols;
    const float* Ds = Ls + kCols;
    float s[kCols / 8][4], dp[kCols / 8][4];
    mma::warp_dots<D, kCols>(Ks + 16 * warp * Lp, Qs, s);
    mma::warp_dots<D, kCols>(Vs + 16 * warp * Lp, Gs, dp);
    const int q0 = q_of(it);
    const bool masked = wmz::bd::k_step_masked(k0, L, it % per_head / kHalves);
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1);
        const float p =
            !masked || wmz::bd::allowed(q0 + col, key0 + 8 * (e >> 1), L, bs)
                ? exp2f(fmaf(s[j][e], scale_log2, -Ls[col] * mma::kLog2e))
                : 0.f;
        s[j][e] = p;
        dp[j][e] = (dp[j][e] - Ds[col]) * p * scale;  // ds, scaled
      }
    uint32_t a[kCols / 16][4];
    mma::to_a_frags<kCols>(s, a);  // P^T in bf16
    mma::warp_product<D, kCols>(a, Gs, dva);
    mma::to_a_frags<kCols>(dp, a);  // dS^T in bf16
    mma::warp_product<D, kCols>(a, Qs, dka);
    __syncthreads();  // every warp is done with this stage before its refill
  }
  const long long out = ((long long)b * N * Hkv + hk) * D;
  mma::store_rows<D>(dka, dk + out, (long long)Hkv * D, k0 + 16 * warp, N);
  mma::store_rows<D>(dva, dv + out, (long long)Hkv * D, k0 + 16 * warp, N);
}

template <int D>
cudaError_t launch_bd_dq(const void* q, const void* k, const void* v, const void* o,
                         const void* g, const float* lse, void* dq, float* delta,
                         const long long* st, int B, int H, int group, int N, int bs,
                         float scale, cudaStream_t stream) {
  constexpr int kOwn = 16 * kWarps;
  const size_t bytes = mma::tile_bytes<D>(2 * kOwn + 4 * wmz::bd::kTile);
  auto kernel = bdflash_bwd_dq_kernel<D>;
  const cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(N / kOwn), (unsigned)H, (unsigned)B);
  wmz::note_launch(kernel);
  kernel<<<grid, 32 * kWarps, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(o), static_cast<const bf16*>(g), lse, static_cast<bf16*>(dq),
      delta, at(st, 0), at(st, 1), at(st, 2), at(st, 3), at(st, 4), H, group, N, N / 2, bs,
      scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bd_dkv(const void* q, const void* k, const void* v, const void* g,
                          const float* lse, const float* delta, void* dk, void* dv,
                          const long long* st, int B, int Hkv, int group, int N, int bs,
                          float scale, cudaStream_t stream) {
  constexpr int kOwn = 16 * kWarps, C = 32;
  const size_t bytes = mma::tile_bytes<D>(2 * kOwn + 4 * C) + 4 * C * sizeof(float);
  auto kernel = bdflash_bwd_dkv_kernel<D, C>;
  const cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(N / kOwn), (unsigned)Hkv, (unsigned)B);
  wmz::note_launch(kernel);
  kernel<<<grid, 32 * kWarps, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(g), lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      at(st, 0), at(st, 1), at(st, 2), at(st, 3), Hkv, group, N, N / 2, bs, scale);
  return cudaGetLastError();
}
}  // namespace

// strides: int64 [15], the b, h, n element strides of q, k, v, o, g.
// dtype: 0 = float32 (the CUDA-core kernels), 1 = bfloat16 (the tensor-core
// kernels). Returns the launch's cudaError_t.
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
#undef WMZ_FLASH_DQ
#define WMZ_FLASH_DQ_MMA(DD)                                                \
  return (int)launch_dq_mma<DD>(q, k, v, o, g, ls, dq, dl, strides, B, H, N, \
                                scale, st)
  if (D == 64) WMZ_FLASH_DQ_MMA(64);
  WMZ_FLASH_DQ_MMA(128);
#undef WMZ_FLASH_DQ_MMA
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
#undef WMZ_FLASH_DKV
#define WMZ_FLASH_DKV_MMA(DD)                                                  \
  return (int)launch_dkv_mma<DD>(q, k, v, g, ls, dl, dk, dv, strides, B, H, N, \
                                 scale, st)
  if (D == 64) WMZ_FLASH_DKV_MMA(64);
  WMZ_FLASH_DKV_MMA(128);
#undef WMZ_FLASH_DKV_MMA
}

// The block-diffusion GQA backward pair (bdflash_bwd_dq_kernel,
// bdflash_bwd_dkv_kernel), bf16, D = 128; the arguments of
// wmz_flash_bwd_dq and wmz_flash_bwd_dkv, with H the query heads (dq) or
// the KV heads (dkv), group the query heads a KV head, N = 2 L (L % 64 ==
// 0) and bs the block (64 % bs == 0).
static bool bd_bad(int D, int group, int N, int bs) {
  return D != 128 || group < 1 || N % 128 || bs < 1 || 64 % bs;
}

extern "C" int wmz_bdflash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                  const void* g, const void* lse, void* dq, void* delta,
                                  const long long* strides, int B, int H, int group, int N,
                                  int D, int bs, float scale, void* stream) {
  if (bd_bad(D, group, N, bs) || H % group) return (int)cudaErrorInvalidValue;
  return (int)launch_bd_dq<128>(q, k, v, o, g, static_cast<const float*>(lse), dq,
                                static_cast<float*>(delta), strides, B, H, group, N, bs, scale,
                                static_cast<cudaStream_t>(stream));
}

extern "C" int wmz_bdflash_bwd_dkv(const void* q, const void* k, const void* v, const void* g,
                                   const void* lse, const void* delta, void* dk, void* dv,
                                   const long long* strides, int B, int Hkv, int group, int N,
                                   int D, int bs, float scale, void* stream) {
  if (bd_bad(D, group, N, bs)) return (int)cudaErrorInvalidValue;
  return (int)launch_bd_dkv<128>(q, k, v, g, static_cast<const float*>(lse),
                                 static_cast<const float*>(delta), dk, dv, strides, B, Hkv,
                                 group, N, bs, scale, static_cast<cudaStream_t>(stream));
}

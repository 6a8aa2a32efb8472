// VQ nearest-code search, for Hopper (sm_90a).
//
// Replaces the index-only form of world_modelz_tpu/kernels/vq_kernels.py:
// `_vq_kernel` (:34) as `vq_encode_pallas` (:69) launches it with
// `return_quantized=False` (:129) for tokenizer encode
// (models/tokenizer.py:227-236).
//
// What it computes. For each row x of (N, D): argmin_k (|e_k|^2 - 2 x.e_k)
// over the (K, D) f32 codebook, accumulated in f32; ties go to the lowest k,
// as jnp.argmin does. |x|^2 is constant per row and dropped, as the TPU
// kernel drops it. Output is int32 (N,).
//
// What bounds it on the H100. At the serving encode batch (N = 8 clips x 6
// frames x 64 tokens = 3,072 rows, K = 512, D = 64) the work is ~201 MFLOP
// (~3 us at the 67 TFLOP/s f32 CUDA-core rate) against ~0.9 MB of traffic
// (~0.3 us at 3.35 TB/s): bound by f32 operations. Index parity with the
// plain version depends on f32 distances, so no TF32 or bf16 tensor-core
// products are used.
//
// Design. Two launches. A prep kernel writes the codebook transposed,
// e_t (D, K), and |e_k|^2 (K,) into scratch the wrapper allocates. The
// search kernel is a register-tiled f32 product on the CUDA cores: a CTA
// takes kRows = 16 rows and all K codes in chunks of kChunk = 128; each of
// its 128 threads owns a 4-row x 4-code tile, so one 16-byte shared-memory
// read of x (4 rows at one d) and one of e_t (4 codes at one d) feed 16
// FMAs. x and the e_t chunk are staged in shared memory with d outermost
// (unrolled 16-byte loads, many in flight, since the chunk comes from L2),
// so a warp's 32 threads read 32 neighbouring 16-byte words of e_t (no
// bank conflicts) and one broadcast word of x. 3,072 rows give 192 CTAs,
// more than the 132 SMs. Each thread keeps, for its 4 rows, the first
// minimum over its codes (strict <, codes visited in increasing k); the 32
// code groups' candidates of a row are merged in group order with ties to
// the lower k.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 16;          // rows per CTA
constexpr int kChunk = 128;        // codes per shared-memory chunk
constexpr int kTile = 4;           // rows and codes of one thread's tile
constexpr int kCodeGroups = kChunk / kTile;            // 32: one per lane
constexpr int kRowGroups = kRows / kTile;              // 4: one per warp
constexpr int kThreads = kCodeGroups * kRowGroups;     // 128
constexpr int kXStride = kRows + 4;  // padded, 16-byte aligned rows of x_s
constexpr int kMaxD = 64;            // shared memory: 41 KB at D = 64

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// one warp per code: e_t[d][k] = e[k][d], e_sq[k] = |e_k|^2 (lane partial
// sums, then a shuffle tree)
__global__ void vq_prep_kernel(const float* __restrict__ codebook,
                               float* __restrict__ e_t,
                               float* __restrict__ e_sq, int K, int D) {
  const int k = (int)((blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (k >= K) return;  // whole warps only
  float sq = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float e = codebook[(long long)k * D + d];
    sq = fmaf(e, e, sq);
    e_t[(long long)d * K + k] = e;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sq += __shfl_xor_sync(0xffffffffu, sq, off);
  if (lane == 0) e_sq[k] = sq;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
vq_search_kernel(const T* __restrict__ x, const float* __restrict__ e_t,
                 const float* __restrict__ e_sq, int32_t* __restrict__ idx,
                 int N, int K, int D) {
  __shared__ __align__(16) float x_s[kMaxD * kXStride];  // x_s[d][row]
  __shared__ __align__(16) float e_s[kMaxD * kChunk];    // e_s[d][code]
  __shared__ float cand_d[kCodeGroups][kRows];
  __shared__ int cand_k[kCodeGroups][kRows];

  const int cg = threadIdx.x % kCodeGroups;  // lane: codes 4cg .. 4cg+3
  const int rg = threadIdx.x / kCodeGroups;  // warp: rows 4rg .. 4rg+3
  const long long row0 = (long long)blockIdx.x * kRows;

#pragma unroll 8
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const long long row = row0 + r;
    x_s[d * kXStride + r] = row < N ? to_f32(x[row * D + d]) : 0.f;
  }

  float best[kTile];
  int best_k[kTile];
#pragma unroll
  for (int a = 0; a < kTile; ++a) {
    best[a] = INFINITY;
    best_k[a] = 0x7fffffff;
  }

  for (int k0 = 0; k0 < K; k0 += kChunk) {
    const int nk = min(kChunk, K - k0);
    __syncthreads();  // x_s is written; the previous chunk is consumed
    // unrolled so that many loads are in flight at once: the chunk comes
    // from L2, and one load at a time would pay its latency per element
    if (K % 4 == 0) {  // then k0 and nk are multiples of 4: 16-byte loads
#pragma unroll 8
      for (int i = threadIdx.x; i < D * kChunk / 4; i += kThreads) {
        const int d = i / (kChunk / 4), c = (i % (kChunk / 4)) * 4;
        *reinterpret_cast<float4*>(e_s + d * kChunk + c) =
            c < nk ? *reinterpret_cast<const float4*>(e_t + (long long)d * K + k0 + c)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else {
#pragma unroll 8
      for (int i = threadIdx.x; i < D * kChunk; i += kThreads) {
        const int d = i / kChunk, c = i % kChunk;
        e_s[i] = c < nk ? e_t[(long long)d * K + k0 + c] : 0.f;
      }
    }
    __syncthreads();

    float dot[kTile][kTile];  // [row][code]
#pragma unroll
    for (int a = 0; a < kTile; ++a)
#pragma unroll
      for (int b = 0; b < kTile; ++b) dot[a][b] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 xv = *reinterpret_cast<const float4*>(
          x_s + d * kXStride + rg * kTile);
      const float4 ev = *reinterpret_cast<const float4*>(
          e_s + d * kChunk + cg * kTile);
      const float xa[kTile] = {xv.x, xv.y, xv.z, xv.w};
      const float eb[kTile] = {ev.x, ev.y, ev.z, ev.w};
#pragma unroll
      for (int a = 0; a < kTile; ++a)
#pragma unroll
        for (int b = 0; b < kTile; ++b) dot[a][b] = fmaf(xa[a], eb[b], dot[a][b]);
    }
#pragma unroll
    for (int b = 0; b < kTile; ++b) {
      const int c = cg * kTile + b;
      if (c < nk) {
        const float sq = e_sq[k0 + c];
#pragma unroll
        for (int a = 0; a < kTile; ++a) {
          const float dist = sq - 2.f * dot[a][b];
          if (dist < best[a]) {  // strict: the lowest k keeps a tie
            best[a] = dist;
            best_k[a] = k0 + c;
          }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < kTile; ++a) {
    cand_d[cg][rg * kTile + a] = best[a];
    cand_k[cg][rg * kTile + a] = best_k[a];
  }
  __syncthreads();
  if (threadIdx.x < kRows && row0 + threadIdx.x < N) {
    const int r = threadIdx.x;
    float bd = cand_d[0][r];
    int bk = cand_k[0][r];
    for (int g = 1; g < kCodeGroups; ++g) {
      const float d = cand_d[g][r];
      const int kk = cand_k[g][r];
      if (d < bd || (d == bd && kk < bk)) {
        bd = d;
        bk = kk;
      }
    }
    idx[row0 + r] = bk;
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* codebook, float* e_t,
                   float* e_sq, int32_t* idx, int N, int K, int D,
                   cudaStream_t stream) {
  vq_prep_kernel<<<(K + 7) / 8, 256, 0, stream>>>(codebook, e_t, e_sq, K, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((N + kRows - 1) / kRows)), block(kThreads);
  vq_search_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), e_t, e_sq, idx, N, K, D);
  return cudaGetLastError();
}

}  // namespace

// x_dtype: 0 = float32, 1 = bfloat16; the codebook is always float32.
// e_t (D, K) and e_sq (K,) are f32 scratch. Returns the cudaError_t of the
// launches.
extern "C" int wmz_vq_encode(const void* x, const void* codebook, void* e_t,
                             void* e_sq, void* idx, int N, int K, int D,
                             int x_dtype, void* stream) {
  if (N <= 0 || K <= 0 || D <= 0 || D > kMaxD) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* cb = static_cast<const float*>(codebook);
  float* et = static_cast<float*>(e_t);
  float* sq = static_cast<float*>(e_sq);
  int32_t* out = static_cast<int32_t*>(idx);
  cudaError_t err;
  if (x_dtype == 0) {
    err = launch<float>(x, cb, et, sq, out, N, K, D, st);
  } else if (x_dtype == 1) {
    err = launch<__nv_bfloat16>(x, cb, et, sq, out, N, K, D, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

extern "C" const char* wmz_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

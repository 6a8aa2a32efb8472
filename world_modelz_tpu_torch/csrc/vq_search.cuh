// VQ nearest-code search shared by the encode kernel (vq_encode.cu) and the
// training-statistics kernel (vq_train.cu), so that the codes used in
// training and the tokens seen at inference are the same for every row.
//
// What it computes. For each row x of (N, D): argmin_k (|e_k|^2 - 2 x.e_k)
// over the (K, D) f32 codebook, accumulated in f32 on the CUDA cores (no
// TF32 or bf16 tensor-core products: index parity with the plain version
// depends on f32 distances); ties go to the lowest k, as jnp.argmin does.
// |x|^2 is constant per row and dropped, as the TPU kernels drop it.
//
// Design. A prep kernel writes the codebook transposed, e_t (D, K), and
// |e_k|^2 (K,) into scratch the wrapper allocates. search_rows is the body
// of one CTA: it takes kRows = 16 rows and all K codes in chunks of
// kChunk = 128; each of its 128 threads owns a 4-row x 4-code tile, so one
// 16-byte shared-memory read of x (4 rows at one d) and one of e_t (4 codes
// at one d) feed 16 FMAs. x and the e_t chunk are staged in shared memory
// with d outermost (unrolled 16-byte loads, many in flight, since the chunk
// comes from L2), so a warp's 32 threads read 32 neighbouring 16-byte words
// of e_t (no bank conflicts) and one broadcast word of x. Each thread
// keeps, for its 4 rows, the first minimum over its codes (strict <, codes
// visited in increasing k); the 32 code groups' candidates of a row are
// merged in group order with ties to the lower k.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "launch_log.cuh"

namespace {

constexpr int kRows = 16;          // rows per CTA
constexpr int kChunk = 128;        // codes per shared-memory chunk
constexpr int kTile = 4;           // rows and codes of one thread's tile
constexpr int kCodeGroups = kChunk / kTile;            // 32: one per lane
constexpr int kRowGroups = kRows / kTile;              // 4: one per warp
constexpr int kThreads = kCodeGroups * kRowGroups;     // 128
constexpr int kXStride = kRows + 4;  // padded, 16-byte aligned rows of x_s
constexpr int kMaxD = 64;            // shared memory: 41 KB at D = 64

// one CTA's shared memory for search_rows; x_s stays valid after it
struct __align__(16) SearchSmem {
  float x_s[kMaxD * kXStride];  // x_s[d * kXStride + row]
  float e_s[kMaxD * kChunk];    // e_s[d * kChunk + code]
  float cand_d[kCodeGroups][kRows];
  int cand_k[kCodeGroups][kRows];
};

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

inline cudaError_t launch_prep(const float* codebook, float* e_t, float* e_sq,
                               int K, int D, cudaStream_t stream) {
  wmz::note_launch(vq_prep_kernel);
  vq_prep_kernel<<<(K + 7) / 8, 256, 0, stream>>>(codebook, e_t, e_sq, K, D);
  return cudaGetLastError();
}

// The search of one CTA (kThreads threads) over rows row0 .. row0 + kRows
// - 1 (rows past N read as zeros). On return, thread r < kRows holds row
// row0 + r's minimum of |e_k|^2 - 2 x.e_k in best_d and its code in
// best_k; sm.x_s holds the rows' x in f32. Every thread of the CTA must
// call it (it synchronises the CTA).
template <typename T>
__device__ __forceinline__ void search_rows(
    const T* __restrict__ x, const float* __restrict__ e_t,
    const float* __restrict__ e_sq, int N, int K, int D, long long row0,
    SearchSmem& sm, float& best_d, int& best_k) {
  const int cg = threadIdx.x % kCodeGroups;  // lane: codes 4cg .. 4cg+3
  const int rg = threadIdx.x / kCodeGroups;  // warp: rows 4rg .. 4rg+3

#pragma unroll 8
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const long long row = row0 + r;
    sm.x_s[d * kXStride + r] = row < N ? to_f32(x[row * D + d]) : 0.f;
  }

  float best[kTile];
  int bestk[kTile];
#pragma unroll
  for (int a = 0; a < kTile; ++a) {
    best[a] = INFINITY;
    bestk[a] = 0x7fffffff;
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
        *reinterpret_cast<float4*>(sm.e_s + d * kChunk + c) =
            c < nk ? *reinterpret_cast<const float4*>(e_t + (long long)d * K + k0 + c)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else {
#pragma unroll 8
      for (int i = threadIdx.x; i < D * kChunk; i += kThreads) {
        const int d = i / kChunk, c = i % kChunk;
        sm.e_s[i] = c < nk ? e_t[(long long)d * K + k0 + c] : 0.f;
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
          sm.x_s + d * kXStride + rg * kTile);
      const float4 ev = *reinterpret_cast<const float4*>(
          sm.e_s + d * kChunk + cg * kTile);
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
            bestk[a] = k0 + c;
          }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < kTile; ++a) {
    sm.cand_d[cg][rg * kTile + a] = best[a];
    sm.cand_k[cg][rg * kTile + a] = bestk[a];
  }
  __syncthreads();
  if (threadIdx.x < kRows) {
    const int r = threadIdx.x;
    float bd = sm.cand_d[0][r];
    int bk = sm.cand_k[0][r];
    for (int g = 1; g < kCodeGroups; ++g) {
      const float d = sm.cand_d[g][r];
      const int kk = sm.cand_k[g][r];
      if (d < bd || (d == bd && kk < bk)) {
        bd = d;
        bk = kk;
      }
    }
    best_d = bd;
    // a row whose distances are all NaN takes code 0, as argmin gives it
    best_k = bk == 0x7fffffff ? 0 : bk;
  }
}

}  // namespace

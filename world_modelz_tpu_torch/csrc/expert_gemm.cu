// Grouped bf16 GEMMs of a mixture-of-experts layer's SwiGLU experts on
// Hopper (sm_90a), with per-expert row counts that stay on the device.
//
// Replaces no TPU kernel: the JAX package's experts are einsums over a
// capacity-padded dispatch tensor (parallel/moe.py), and the port's
// top-1 layer runs them as f32 cuBLAS products. These kernels were added
// for SDAR's dropless top-8 expert layer (parallel/moe.py:
// moe_swiglu_held), so that no token is dropped and nothing is read on the
// host: a step that uses them captures in a CUDA graph.
//
// Layout. The rows routed to the held experts are grouped by expert into
// one buffer, each expert's group padded with zero rows to a multiple of
// 128 (`offsets`, E + 1 int32 on the device, offsets[0] = 0), so that a
// 128-row tile belongs to one expert. Two kernels:
//
// - `expert_gemm_rows_kernel<TransB, Epi>`: C = A op(B_e) for the rows of
//   each expert: A (rows, K) bf16; B_e (N, K) (TransB 0: the forward's
//   weight) or (K, N) (TransB 1: the backward's dgrad); epilogues: 0 a
//   plain bf16 store; 1 the forward's gate | up with SwiGLU (each
//   128-column tile holds 64 gate and 64 up columns of one expert, so a
//   thread holds both halves of its outputs: it stores G | U, kept for the
//   backward, and act = silu(G) U); 2 the backward's SwiGLU (dA in the
//   accumulators, G | U read back: it stores dG | dU).
// - `expert_gemm_wgrad_kernel`: dW_e = A_e^T B_e over the expert's rows
//   (both operands MN-major), (M, N) bf16 a expert.
//
// Rounding: the products sum in f32 and round to bf16 at their outputs;
// the SwiGLU epilogues round where PyTorch's bf16 operations do (G, U,
// silu(G), act; dU, dA U, dG), which the plain versions in
// kernels/expert_gemm.py repeat.
//
// Bound: at the SDAR cell's shape (32,768 assignments a layer to 16 held
// experts of width 768 over hidden 2,048) the forward's two products are
// 309 GFLOP a layer (~0.31 ms at the bf16 peak) against ~0.3 GB of
// operands (~0.1 ms): bound by operations. Design: a block of two
// warpgroups owns a 128 x 128 output tile; A and B stream through a ring
// of three 64-deep stages of 128-byte swizzled tiles by cp.async; each
// warpgroup issues wgmma m64n128k16 from shared memory (MN-major operands
// transposed by the instruction) and waits for it before the stage is
// refilled. No atomics: two launches are bitwise equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "flash_mma.cuh"
#include "launch_log.cuh"
#include "wgmma.cuh"

namespace {

namespace mma = wmz::mma;
namespace wg = wmz::wg;
using bf16 = __nv_bfloat16;

constexpr int kBM = 128, kBN = 128, kBK = 64, kStages = 3, kThreads = 256;
constexpr int kTileElems = kBM * kBK;  // one operand's stage, 16 KB
constexpr size_t kSmemBytes = 2 * kStages * kTileElems * sizeof(bf16) + 1024;

__device__ __forceinline__ bf16* aligned_smem(unsigned char* raw) {
  const uint32_t a = mma::smem_addr(raw);
  return reinterpret_cast<bf16*>(raw + ((1024 - (a & 1023)) & 1023));
}

__device__ __forceinline__ void landed() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

__device__ __forceinline__ float rb(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

// the 64-deep products of one stage for this warpgroup's 64 rows
template <int TransA, int TransB>
__device__ __forceinline__ void stage_products(float acc[16][4], const bf16* As, const bf16* Bs,
                                               int wgi) {
  wg::fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint64_t da = TransA ? wg::desc_mn<kBK>(As + wgi * 64 * 64, kk)
                               : wg::desc_k<kBM>(As + wgi * 64 * 64, kk);
    const uint64_t db = TransB ? wg::desc_mn<kBK>(Bs, kk) : wg::desc_k<kBN>(Bs, kk);
    wg::mma_ss_n128<TransA, TransB>(acc, da, db, 1);
  }
  wg::commit();
  wg::fence_regs<16>(acc);
  wg::wait<0>();
  wg::fence_regs<16>(acc);
}

// the expert whose padded rows hold row m (offsets[E] > m)
__device__ __forceinline__ int expert_of(const int* __restrict__ offsets, int E, int m) {
  int e = 0;
  while (e + 1 < E && offsets[e + 1] <= m) ++e;
  return e;
}

template <int TransB, int Epi>
__global__ void __launch_bounds__(kThreads)
expert_gemm_rows_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                        bf16* __restrict__ c, bf16* __restrict__ aux,
                        const int* __restrict__ offsets, int E, int N, int K,
                        long long b_stride, int inter) {
  extern __shared__ unsigned char smem_raw[];
  bf16* As = aligned_smem(smem_raw);
  bf16* Bs = As + kStages * kTileElems;
  const int m0 = blockIdx.y * kBM, nt = blockIdx.x;
  const int rows = offsets[E];
  if (m0 >= rows) return;
  const bf16* be = b + (long long)expert_of(offsets, E, m0) * b_stride;
  // B's rows (TransB 0) or columns (TransB 1) of this tile
  const int n_b = Epi == 1 ? 64 * nt : kBN * nt;
  const int b_rows = Epi == 1 ? 2 * inter : (TransB ? K : N);
  auto issue = [&](int kt) {
    bf16* as = As + (kt % kStages) * kTileElems;
    bf16* bs = Bs + (kt % kStages) * kTileElems;
    const int k0 = kt * kBK;
    wg::load_rows_async<kBK, kBM>(as, a + k0, K, m0, rows);
    if (TransB) {
      wg::load_rows_async<kBN, kBK>(bs, be + n_b, N, k0, b_rows);
    } else if (Epi == 1) {  // gate rows, then the matching up rows
      wg::load_rows_async<kBK, kBN>(bs, be + k0, K, n_b, b_rows, 0, 64);
      wg::load_rows_async<kBK, kBN>(bs, be + k0, K, inter + n_b, b_rows, 64, 64);
    } else {
      wg::load_rows_async<kBK, kBN>(bs, be + k0, K, n_b, b_rows);
    }
  };
  const int nk = K / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) issue(s);
    mma::cp_async_commit();
  }
  float acc[16][4];
  mma::zero<16>(acc);
  const int wgi = threadIdx.x >> 7;
  for (int kt = 0; kt < nk; ++kt) {
    mma::cp_async_wait<kStages - 2>();
    landed();
    if (kt + kStages - 1 < nk) issue(kt + kStages - 1);
    mma::cp_async_commit();
    stage_products<0, TransB>(acc, As + (kt % kStages) * kTileElems,
                              Bs + (kt % kStages) * kTileElems, wgi);
  }

  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long row = m0 + 64 * wgi + 16 * w + g + 8 * i;
    if (Epi == 0) {
      bf16* out = c + row * N + kBN * nt + 2 * t;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<uint32_t*>(out + 8 * j) = mma::pack_bf16(acc[j][2 * i], acc[j][2 * i + 1]);
    } else if (Epi == 1) {  // G | U and act = silu(G) U
      bf16* gu = c + row * 2 * inter + 64 * nt + 2 * t;
      bf16* act = aux + row * inter + 64 * nt + 2 * t;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float gv[2], uv[2], av[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          gv[e] = rb(acc[j][2 * i + e]);
          uv[e] = rb(acc[j + 8][2 * i + e]);
          av[e] = rb(silu(gv[e])) * uv[e];
        }
        *reinterpret_cast<uint32_t*>(gu + 8 * j) = mma::pack_bf16(gv[0], gv[1]);
        *reinterpret_cast<uint32_t*>(gu + inter + 8 * j) = mma::pack_bf16(uv[0], uv[1]);
        *reinterpret_cast<uint32_t*>(act + 8 * j) = mma::pack_bf16(av[0], av[1]);
      }
    } else {  // dA in acc; G | U from aux -> dG | dU
      const bf16* gu = aux + row * 2 * inter + kBN * nt + 2 * t;
      bf16* dgu = c + row * 2 * inter + kBN * nt + 2 * t;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const __nv_bfloat162 g2 = *reinterpret_cast<const __nv_bfloat162*>(gu + 8 * j);
        const __nv_bfloat162 u2 = *reinterpret_cast<const __nv_bfloat162*>(gu + inter + 8 * j);
        const float gv[2] = {__low2float(g2), __high2float(g2)};
        const float uv[2] = {__low2float(u2), __high2float(u2)};
        float dg[2], du[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float da = rb(acc[j][2 * i + e]);
          du[e] = da * rb(silu(gv[e]));
          const float ds = rb(da * uv[e]);
          const float sig = 1.f / (1.f + expf(-gv[e]));
          dg[e] = ds * (sig * (1.f + gv[e] * (1.f - sig)));
        }
        *reinterpret_cast<uint32_t*>(dgu + 8 * j) = mma::pack_bf16(dg[0], dg[1]);
        *reinterpret_cast<uint32_t*>(dgu + inter + 8 * j) = mma::pack_bf16(du[0], du[1]);
      }
    }
  }
}

// dW_e (M, N) = A_e^T B_e: A (rows, M), B (rows, N), the expert's rows
// offsets[e] .. offsets[e + 1]
__global__ void __launch_bounds__(kThreads)
expert_gemm_wgrad_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                         bf16* __restrict__ c, const int* __restrict__ offsets, int M, int N) {
  extern __shared__ unsigned char smem_raw[];
  bf16* As = aligned_smem(smem_raw);
  bf16* Bs = As + kStages * kTileElems;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM, e = blockIdx.z;
  const int r0 = offsets[e], r1 = offsets[e + 1];
  auto issue = [&](int kt) {
    const int k0 = r0 + kt * kBK;
    wg::load_rows_async<kBM, kBK>(As + (kt % kStages) * kTileElems, a + m0, M, k0, r1);
    wg::load_rows_async<kBN, kBK>(Bs + (kt % kStages) * kTileElems, b + n0, N, k0, r1);
  };
  const int nk = (r1 - r0) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) issue(s);
    mma::cp_async_commit();
  }
  float acc[16][4];
  mma::zero<16>(acc);
  const int wgi = threadIdx.x >> 7;
  for (int kt = 0; kt < nk; ++kt) {
    mma::cp_async_wait<kStages - 2>();
    landed();
    if (kt + kStages - 1 < nk) issue(kt + kStages - 1);
    mma::cp_async_commit();
    stage_products<1, 1>(acc, As + (kt % kStages) * kTileElems,
                         Bs + (kt % kStages) * kTileElems, wgi);
  }
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long row = m0 + 64 * wgi + 16 * w + g + 8 * i;
    bf16* out = c + ((long long)e * M + row) * N + n0 + 2 * t;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j) = mma::pack_bf16(acc[j][2 * i], acc[j][2 * i + 1]);
  }
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)kSmemBytes);
}

template <int TransB, int Epi>
cudaError_t launch_rows(const void* a, const void* b, void* c, void* aux, const int* offsets,
                        int E, int rows_max, int N, int K, long long b_stride, int inter,
                        cudaStream_t stream) {
  auto kernel = expert_gemm_rows_kernel<TransB, Epi>;
  const cudaError_t err = prepare(kernel);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(Epi == 1 ? inter / 64 : N / kBN), (unsigned)(rows_max / kBM));
  wmz::note_launch(kernel);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b), static_cast<bf16*>(c),
      static_cast<bf16*>(aux), offsets, E, N, K, b_stride, inter);
  return cudaGetLastError();
}

}  // namespace

// The grouped product of every held expert's rows: a (rows_max, K) bf16,
// rows grouped by expert as `offsets` (E + 1 int32 on the device, each a
// multiple of 128) says; b: E weights, b_stride elements apart. mode 0:
// c (rows, N) = a b_e^T, b_e (N, K); mode 1: the SwiGLU forward, b_e
// (2 inter, K) gate then up, c (rows, 2 inter) = G | U, aux (rows, inter)
// = silu(G) U; mode 2: c (rows, N) = a b_e, b_e (K, N); mode 3: the SwiGLU
// backward, a = dY, b_e (K, N = inter) the down weight, aux (rows, 2 N) =
// G | U, c (rows, 2 N) = dG | dU. K % 64 == 0, N % 128 == 0 (mode 1: inter
// % 64), rows_max % 128 == 0. Returns the launch's cudaError_t.
extern "C" int wmz_expert_gemm(const void* a, const void* b, void* c, void* aux,
                               const void* offsets, int E, int rows_max, int N, int K,
                               long long b_stride, int inter, int mode, void* stream) {
  if (K % kBK || rows_max % kBM || E < 1) return (int)cudaErrorInvalidValue;
  if (mode == 1 ? inter % 64 || N != 2 * inter : N % kBN) return (int)cudaErrorInvalidValue;
  if (mode == 3 && inter != N) return (int)cudaErrorInvalidValue;
  const int* off = static_cast<const int*>(offsets);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return (int)launch_rows<0, 0>(a, b, c, aux, off, E, rows_max, N, K, b_stride, inter, st);
    case 1: return (int)launch_rows<0, 1>(a, b, c, aux, off, E, rows_max, N, K, b_stride, inter, st);
    case 2: return (int)launch_rows<1, 0>(a, b, c, aux, off, E, rows_max, N, K, b_stride, inter, st);
    case 3: return (int)launch_rows<1, 2>(a, b, c, aux, off, E, rows_max, N, K, b_stride, inter, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dW_e = a_e^T b_e for each held expert e: a (rows_max, M), b (rows_max,
// N), c (E, M, N) bf16; M % 128 == 0, N % 128 == 0.
extern "C" int wmz_expert_gemm_wgrad(const void* a, const void* b, void* c, const void* offsets,
                                     int E, int M, int N, void* stream) {
  if (M % kBM || N % kBN || E < 1) return (int)cudaErrorInvalidValue;
  auto kernel = expert_gemm_wgrad_kernel;
  const cudaError_t err = prepare(kernel);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(N / kBN), (unsigned)(M / kBM), (unsigned)E);
  wmz::note_launch(kernel);
  kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b), static_cast<bf16*>(c),
      static_cast<const int*>(offsets), M, N);
  return (int)cudaGetLastError();
}

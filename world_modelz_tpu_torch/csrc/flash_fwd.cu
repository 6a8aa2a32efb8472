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
// In bf16 it rounds P where the stock kernel does. That kernel walks the
// keys in blocks of `block` keys (512, 256 or 128, as
// `_flash_dense_attention` picks it) and per block, with the running max m
// and sum l: m' = max(m, max s), P = exp(s - m'), l_corr = exp(m - m') l,
// l' = sum P + l_corr, acc = acc * (l_corr / l') + (bf16(P) v) / l'
// (:440-473). A single block (`normalise`) rounds P / l instead
// (:540-553).
//
// What bounds it on the H100. At the sparse trainer's shape (B=16, H=8,
// N=1024, D=64, bf16) it reads q, k, v (25 MB) and writes out and lse: ~8 us
// at 3.35 TB/s, against 4 B H N^2 D = 34.4 GFLOP of products, ~35 us at the
// bf16 tensor-core peak: bound by operations. In f32, at the evaluation
// sweep's shape (B=8, H=8, N=1024, D=64), 4 B H N^2 D = 17.2 GFLOP would
// take 256 us at the 67 TFLOP/s of f32 FMAs on the CUDA cores; on the
// tensor cores the kernel executes three TF32 products for each f32
// product (below), 51.5 GFLOP, 104 us at the 495 TFLOP/s TF32 peak,
// against 20 us for its 67 MB: bound by operations.
//
// Design, bf16: flash_mma.cuh's tiling. A block of 8 warps owns 128
// queries of one (b, h), 16 per warp, with Q held as mma A fragments in
// registers (D = 64; D = 128 reads them from shared memory). Per key block
// it walks the block's keys twice, 128 (D = 64) or 64 keys a step, with
// the next step's cp.async copies in flight: sweep 1 reads K only, twice
// as many keys a step, and takes S = Q K^T (mma.sync m16n8k16) for the
// block's row max (and, when normalising, the online sum); sweep 2 reads
// K and V, recomputes S, forms P = exp(s - m'), sums it, rounds it into
// the A fragments of P V (`to_a_frags`) and accumulates P V in a second
// set of f32 registers, which the block's end folds into acc in the stock
// kernel's order. The max has to be known before P is rounded, so Q K^T
// runs twice: 1.5x the products of one pass. exp is the SFU's (__expf),
// and P / l is P times l's correctly rounded reciprocal: each within a
// few f32 ulps of the stock kernel's value before the bf16 rounding.
//
// Design, f32: the tensor cores in split TF32 (mma.sync m16n8k8 .tf32),
// whatever torch.backends.cuda.matmul.allow_tf32 says. One TF32 product
// keeps ~10 mantissa bits, ~1e-3 relative, too coarse for the f32 parity
// gate (1e-4); so every operand x is split into hi = tf32(x) and lo =
// tf32(x - hi) (cvt.rna, round to nearest, ties away), and each product a
// b is taken as lo_a hi_b + hi_a lo_b + hi_a hi_b, accumulated in f32,
// small terms first: within f32 rounding of the f32 product (lo_a lo_b,
// ~2^-22 relative, is dropped). Q is split as its fragments are read, K
// and V as theirs are, P in registers. In f32, rounding P to the operand
// type is the identity, so there are no rounding points to keep and one
// online sweep over the keys serves: per 64-key step the running max m
// and sum l, acc rescaled by exp(m - m') as the max moves, exp the SFU's
// and out = acc times l's correctly rounded reciprocal. The tensor cores
// add a product's terms to the accumulator they are given less exactly
// than an f32 add (on the card, out was ~5e-6 from float64 with S and acc
// as the running accumulators, against ~5e-7 for f32 FMAs; PERF.md, PR
// 9): so each 8-deep step of S takes its three products into zeroed
// registers, added to S in f32, and each 64-key step's P V is summed
// apart and folded into acc by one f32 FMA with the rescale. Layouts: the S
// accumulators of an m16n8 tile hold (row g, columns 2t, 2t + 1), where
// the m16n8k8 A fragment of P V wants columns t and t + 4. P V sums over
// its k index, so the kernel reads the C columns {2t, 2t + 1} as A's
// k-slots {t, t + 4} and loads V's B fragment from rows 2t and 2t + 1 of
// the 8-key step: both sides take the same permutation and no lane
// shuffles. A block of 8 warps owns 128 queries of one (b, h), 16 per
// warp; Q (read from shared memory at both head sizes) and a ring of two
// stages of 64 keys of K and V are staged by 16-byte cp.async copies into
// f32 rows padded to D + 4, so that the fragment reads (row g or 2t,
// column t or g) hit 32 different banks. At D = 64 that is 102 KB, and
// two blocks fit on an SM; at D = 128 one. No atomics: two launches are
// bitwise equal. wgmma, a later lever, takes TF32 only K-major, which V
// is not.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "flash_mma.cuh"
#include "bd_mask.cuh"
#include "flash_tile.cuh"
#include "launch_log.cuh"
#include "split_tf32.cuh"

namespace {

using namespace wmz::flash;
namespace mma = wmz::mma;

// ---------------------------------------------------------------- bf16
// The tensor-core forward (flash_mma.cuh): kWarps warps own 16 kWarps
// queries. A stage holds 2 kKeys rows: K and V of kKeys keys in sweep 2,
// K of 2 kKeys keys in sweep 1 (V is not needed there), so a 512-key block
// takes 2 + 4 steps at D = 64. S is taken kSub keys at a time (32 at D =
// 128, so that S, P and both sums fit in registers).

using mma::bf16;
constexpr int kWarps = 8, kOwn = 16 * kWarps;
template <int D>
__host__ __device__ constexpr int keys_per_step() {
  return D == 64 ? 128 : 64;
}

template <int D, bool kNormalise>
__global__ void __launch_bounds__(32 * kWarps)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     float* __restrict__ lse, Strides sq, Strides sk, Strides sv, int H,
                     int N, float scale, int block) {
  constexpr int L = D + mma::kPad, kKeys = keys_per_step<D>(), kSub = D == 64 ? 64 : 32;
  // Q as A fragments in registers at D = 64; at D = 128 they would push
  // the two 16 x D sums out of registers, so Q K^T reads Q from the tile
  constexpr bool kQInRegisters = D == 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* KV = Qs + kOwn * L;  // two stages of 2 kKeys rows
  const int q0 = blockIdx.x * kOwn, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, t = lane & 3;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;
  // per key block (every one starts below N, since N > padded N - 128):
  // n1 sweep-1 steps of k1 keys, then n2 sweep-2 steps of kKeys keys
  const int k1 = min(2 * kKeys, block), n1 = block / k1, n2 = block / kKeys;
  const int per_block = n1 + n2, steps = per_block * ((N + block - 1) / block);
  auto issue = [&](int i) {
    const int r = i % per_block, blk0 = i / per_block * block;
    bf16* stage = KV + (i & 1) * 2 * kKeys * L;
    if (r < n1) {
      const int k0 = blk0 + r * k1;
      mma::load_rows_async<D, kKeys>(stage, kb, sk.n, k0, N);
      if (k1 > kKeys) mma::load_rows_async<D, kKeys>(stage + kKeys * L, kb, sk.n, k0 + kKeys, N);
    } else {
      const int k0 = blk0 + (r - n1) * kKeys;
      mma::load_rows_async<D, kKeys>(stage, kb, sk.n, k0, N);
      mma::load_rows_async<D, kKeys>(stage + kKeys * L, vb, sv.n, k0, N);
    }
  };

  mma::load_rows_async<D, kOwn>(Qs, q + b * sq.b + h * sq.h, sq.n, q0, N);
  issue(0);
  mma::cp_async_commit();

  uint32_t qa[D / 16][4];
  float acc[D / 8][4], o[D / 8][4];
  mma::zero<D / 8>(acc);
  mma::zero<D / 8>(o);
  // this lane's rows gr and gr + 8: the running (m, l) over the finished
  // key blocks, the current block's max (and, with normalise, its online
  // sum) from sweep 1, and this lane's part of sum P in sweep 2
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float m_blk[2], l_blk[2], m_next[2], p_sum[2], inv_l[2];
  // S for kSub keys from row c0 of the stage, the first at key k0 + c0,
  // scaled (s *= sm_scale, rounded apart from the exponent's subtraction)
  // and -inf at or past N; mt: this lane's row maxima
  auto scores = [&](const bf16* Ks, int c0, int k0, float s[kSub / 8][4], float mt[2]) {
    if constexpr (kQInRegisters)
      mma::warp_dots_frags<D, kSub>(qa, Ks + c0 * L, s);
    else
      mma::warp_dots<D, kSub>(Qs + 16 * warp * L, Ks + c0 * L, s);
    const bool full = k0 + c0 + kSub <= N;
    mt[0] = mt[1] = -INFINITY;
#pragma unroll
    for (int j = 0; j < kSub / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = full || k0 + c0 + 8 * j + 2 * t + (e & 1) < N ? __fmul_rn(s[j][e], scale)
                                                                : -INFINITY;
        mt[e >> 1] = fmaxf(mt[e >> 1], s[j][e]);
      }
  };
  for (int it = 0; it < steps; ++it) {
    if (it + 1 < steps) issue(it + 1);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();
    __syncthreads();
    if constexpr (kQInRegisters)
      if (it == 0) mma::load_a_frags<D>(Qs + 16 * warp * L, qa);
    const int r = it % per_block, blk0 = it / per_block * block;
    const bf16* Ks = KV + (it & 1) * 2 * kKeys * L;
    if (r < n1) {  // sweep 1: the block's max; with normalise, its sum online
      if (r == 0) m_blk[0] = m_blk[1] = -INFINITY, l_blk[0] = l_blk[1] = 0.f;
      for (int half = 0; half < k1 / kKeys; ++half)
#pragma unroll
        for (int c0 = half * kKeys; c0 < (half + 1) * kKeys; c0 += kSub) {
          float s[kSub / 8][4], mt[2];
          scores(Ks, c0, blk0 + r * k1, s, mt);
          // the first sub-tile of a block holds a real key: m_new is finite
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float m_new = fmaxf(m_blk[i], mma::quad_max(mt[i]));
            if (kNormalise) {
              float ps = 0.f;
#pragma unroll
              for (int j = 0; j < kSub / 8; ++j)
                ps += __expf(s[j][2 * i] - m_new) + __expf(s[j][2 * i + 1] - m_new);
              l_blk[i] = l_blk[i] * __expf(m_blk[i] - m_new) + mma::quad_sum(ps);
            }
            m_blk[i] = m_new;
          }
        }
      if (r == n1 - 1) {  // sweep 1 done: m', and sweep 2 starts
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          m_next[i] = fmaxf(m_run[i], m_blk[i]);
          p_sum[i] = 0.f;
          inv_l[i] = __frcp_rn(l_blk[i]);
        }
      }
    } else {  // sweep 2: P = exp(s - m'), rounded, into P V
      const bf16* Vs = Ks + kKeys * L;
#pragma unroll
      for (int c0 = 0; c0 < kKeys; c0 += kSub) {
        float s[kSub / 8][4], mt[2];
        scores(Ks, c0, blk0 + (r - n1) * kKeys, s, mt);
#pragma unroll
        for (int j = 0; j < kSub / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            const float p = __expf(__fsub_rn(s[j][e], m_next[i]));
            if (kNormalise) {
              s[j][e] = __fmul_rn(p, inv_l[i]);  // P / l to an f32 ulp
            } else {
              p_sum[i] += p;
              s[j][e] = p;
            }
          }
        uint32_t pa[kSub / 16][4];
        mma::to_a_frags<kSub>(s, pa);  // P to bf16 (flash_attention.py:471)
        mma::warp_product<D, kSub>(pa, Vs + c0 * L, o);
      }
      if (r == per_block - 1) {  // the block's end: fold P V into acc
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (kNormalise) {  // one block: acc = bf16(P / l) v
            l_run[i] = l_blk[i];
          } else {
            const float l_corr = __fmul_rn(__expf(m_run[i] - m_next[i]), l_run[i]);
            const float l_next = __fadd_rn(mma::quad_sum(p_sum[i]), l_corr);
            const float inv = __fdiv_rn(1.f, l_next), keep = __fmul_rn(l_corr, inv);
#pragma unroll
            for (int j = 0; j < D / 8; ++j)
#pragma unroll
              for (int e = 2 * i; e < 2 * i + 2; ++e)
                o[j][e] = __fadd_rn(__fmul_rn(acc[j][e], keep), __fmul_rn(o[j][e], inv));
            l_run[i] = l_next;
          }
          m_run[i] = m_next[i];
        }
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = o[j][e], o[j][e] = 0.f;
      }
    }
    __syncthreads();  // every warp is done with this stage before its refill
  }
  mma::store_rows<D>(acc, out + ((long long)b * N * H + h) * D, (long long)H * D,
                     q0 + 16 * warp, N);
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int n = q0 + 16 * warp + gr + 8 * i;
      if (n < N) lse[((long long)b * H + h) * N + n] = m_run[i] + logf(l_run[i]);
    }
  }
}

// ---------------------------------------------------------------- f32
// The split-TF32 forward: kWarps warps own 16 kWarps queries; a stage
// holds kKeysF keys of K, then of V, as f32 rows padded to D + kPadF.

namespace tf32 {

constexpr int kPadF = 4;    // f32 of padding after each row of a tile
constexpr int kKeysF = 64;  // keys of a step

template <int D>
constexpr size_t tile_bytes(int rows) {
  return (size_t)rows * (D + kPadF) * sizeof(float);
}

// rows [row0, row0 + Rows) of a row-major f32 operand (`base` at row 0,
// row stride `ld_n` elements, 16-byte aligned rows) -> the padded tile
// `dst`; rows at or past N are zero. Every thread of the block takes part.
template <int D, int Rows>
__device__ __forceinline__ void load_rows_async(float* dst, const float* __restrict__ base,
                                                long long ld_n, int row0, int N) {
  constexpr int kChunks = D / 4;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < Rows * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = (i % kChunks) * 4;
    const int n = row0 + r;
    const bool valid = n < N;
    mma::cp_async16(dst + r * (D + kPadF) + c, base + (valid ? n * ld_n : 0) + c, valid);
  }
}

using wmz::split_tf32::split;

// c += a b for one m16n8k8 tile: TF32 operands, f32 sums
__device__ __forceinline__ void mma_1688(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in split TF32, small terms first: lo_a hi_b, hi_a lo_b, hi_a hi_b.
// The A fragment (row g or g + 8, k-slot t or t + 4) as hi and lo halves,
// the B fragment's two values (k-slots t and t + 4 of column g) as f32
__device__ __forceinline__ void mma_split(float c[4], const uint32_t ah[4], const uint32_t al[4],
                                          float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma_1688(c, al, bh0, bh1);
  mma_1688(c, ah, bl0, bl1);
  mma_1688(c, ah, bh0, bh1);
}

// the A fragment of four f32 values (a0: row g, slot t; a1: row g + 8,
// slot t; a2: row g, slot t + 4; a3: row g + 8, slot t + 4), split
__device__ __forceinline__ void split_a(float a0, float a1, float a2, float a3, uint32_t ah[4],
                                        uint32_t al[4]) {
  split(a0, ah[0], al[0]);
  split(a1, ah[1], al[1]);
  split(a2, ah[2], al[2]);
  split(a3, ah[3], al[3]);
}

}  // namespace tf32

template <int D>
__global__ void __launch_bounds__(32 * kWarps, D == 64 ? 2 : 1)
flash_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      float* __restrict__ lse, Strides sq, Strides sk, Strides sv, int H, int N,
                      float scale) {
  using tf32::kKeysF;
  constexpr int L = D + tf32::kPadF;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* KV = Qs + kOwn * L;  // two stages: kKeysF rows of K, then of V
  const int q0 = blockIdx.x * kOwn, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, t = lane & 3;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const int steps = (N + kKeysF - 1) / kKeysF;
  auto issue = [&](int i) {
    float* stage = KV + (i & 1) * 2 * kKeysF * L;
    tf32::load_rows_async<D, kKeysF>(stage, kb, sk.n, i * kKeysF, N);
    tf32::load_rows_async<D, kKeysF>(stage + kKeysF * L, vb, sv.n, i * kKeysF, N);
  };

  tf32::load_rows_async<D, kOwn>(Qs, q + b * sq.b + h * sq.h, sq.n, q0, N);
  issue(0);
  mma::cp_async_commit();

  float acc[D / 8][4];
  mma::zero<D / 8>(acc);
  // this lane's rows gr and gr + 8: the running max and sum
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float* Qw = Qs + (16 * warp + gr) * L + t;
  for (int it = 0; it < steps; ++it) {
    if (it + 1 < steps) issue(it + 1);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();
    __syncthreads();
    const float* Ks = KV + (it & 1) * 2 * kKeysF * L;
    const float* Vs = Ks + kKeysF * L;
    // S = Q K^T for this step's keys: B fragment (depth t and t + 4 of key
    // 8 j + g)
    float s[kKeysF / 8][4];
    mma::zero<kKeysF / 8>(s);
#pragma unroll
    for (int kc = 0; kc < D / 8; ++kc) {
      uint32_t ah[4], al[4];
      const float* qa = Qw + 8 * kc;
      tf32::split_a(qa[0], qa[8 * L], qa[4], qa[8 * L + 4], ah, al);
#pragma unroll
      for (int j = 0; j < kKeysF / 8; ++j) {
        const float* kp = Ks + (8 * j + gr) * L + 8 * kc + t;
        float d[4] = {0.f, 0.f, 0.f, 0.f};  // the step's sum, added in f32
        tf32::mma_split(d, ah, al, kp[0], kp[4]);
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += d[e];
      }
    }
    // scaled (rounded apart from the exponent's subtraction), -inf at or
    // past N; every step holds a real key, so the new max is finite
    const int k0 = it * kKeysF;
    const bool full = k0 + kKeysF <= N;
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kKeysF / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = full || k0 + 8 * j + 2 * t + (e & 1) < N ? __fmul_rn(s[j][e], scale)
                                                            : -INFINITY;
        mt[e >> 1] = fmaxf(mt[e >> 1], s[j][e]);
      }
    float corr[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], mma::quad_max(mt[i]));
      corr[i] = __expf(m[i] - m_new);  // 0 on the first step (m = -inf)
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kKeysF / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = __expf(__fsub_rn(s[j][e], m[e >> 1]));
        ps[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + mma::quad_sum(ps[i]);
    // pv = P V for this step: the C columns {2t, 2t + 1} of key tile j are
    // A's k-slots {t, t + 4}, and V's B fragment takes keys 8 j + 2t and
    // 8 j + 2t + 1; then acc = acc exp(m - m') + pv in f32
    float pv[D / 8][4];
    mma::zero<D / 8>(pv);
#pragma unroll
    for (int j = 0; j < kKeysF / 8; ++j) {
      uint32_t ah[4], al[4];
      tf32::split_a(s[j][0], s[j][2], s[j][1], s[j][3], ah, al);
      const float* vp = Vs + (8 * j + 2 * t) * L + gr;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) tf32::mma_split(pv[c], ah, al, vp[8 * c], vp[L + 8 * c]);
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = fmaf(acc[j][e], corr[e >> 1], pv[j][e]);
    __syncthreads();  // every warp is done with this stage before its refill
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = q0 + 16 * warp + gr + 8 * i;
    if (n >= N) continue;
    const float inv = __frcp_rn(l[i]);
    float* row = out + (((long long)b * N + n) * H + h) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(row + 8 * j) =
          make_float2(__fmul_rn(acc[j][2 * i], inv), __fmul_rn(acc[j][2 * i + 1], inv));
    if (t == 0) lse[((long long)b * H + h) * N + n] = m[i] + logf(l[i]);
  }
}

template <int D>
cudaError_t launch_tf32(const void* q, const void* k, const void* v, void* out, float* lse,
                        const long long* st, int B, int H, int N, float scale,
                        cudaStream_t stream) {
  const size_t bytes = tf32::tile_bytes<D>(kOwn + 4 * tf32::kKeysF);
  auto kernel = flash_fwd_tf32_kernel<D>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((N + kOwn - 1) / kOwn), (unsigned)H, (unsigned)B);
  wmz::note_launch(kernel);
  kernel<<<grid, 32 * kWarps, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), lse, Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, H, N, scale);
  return cudaGetLastError();
}

template <int D, bool kNormalise>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out,
                       float* lse, const long long* st, int B, int H, int N,
                       float scale, int block, cudaStream_t stream) {
  const size_t bytes = mma::tile_bytes<D>(kOwn + 4 * keys_per_step<D>());
  auto kernel = flash_fwd_mma_kernel<D, kNormalise>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((N + kOwn - 1) / kOwn), (unsigned)H, (unsigned)B);
  wmz::note_launch(kernel);
  kernel<<<grid, 32 * kWarps, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse,
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, H, N, scale, block);
  return cudaGetLastError();
}


// ----------------------------------------------- bf16, block diffusion
// `bdflash_fwd_kernel`: GQA attention under the block-diffusion mask
// (bd_mask.cuh) for SDAR's block-diffusion training (models/sdar.py). No
// TPU kernel has this form; it was added for that model. q is (B, Hq, N,
// D), k and v (B, Hkv, N, D) with Hq = group Hkv, query head h reading KV
// head h / group; N = 2 L positions of [x_t ; x_0]. Bound: at the SDAR
// cell's shape (B 8, Hq 32, Hkv 4, N 8,192, D 128) the allowed pairs need
// 4 D pairs = 2.25 TFLOP a layer, ~2.3 ms at the bf16 peak, against ~0.3 GB
// of q, k, v and out: bound by operations; a walk over every tile would do
// 4x the products. Design: flash_mma.cuh's tiling, 4 warps own 64 queries
// of one (b, h), 16 a warp, and walk only the key tiles the mask leaves
// (bd_mask.cuh), K and V of the next tile in flight by cp.async; the
// predicate is evaluated in the one or two masked tiles alone. One online
// softmax pass (FlashAttention-2): per 32 keys the running max and sum, P =
// exp(s - m) rounded to bf16 into the A fragments of P V; out = acc / l.

template <int D>
__global__ void __launch_bounds__(128)
bdflash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ out, float* __restrict__ lse,
                   Strides sq, Strides sk, Strides sv, int H, int group, int N, int L, int bs,
                   float scale) {
  constexpr int kRows = 64, kKeys = wmz::bd::kTile, kSub = 32, Lp = D + mma::kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* KV = Qs + kRows * Lp;  // two stages of kKeys rows of K, then of V
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, t = lane & 3;
  const bf16* kb = k + b * sk.b + hk * sk.h;
  const bf16* vb = v + b * sv.b + hk * sv.h;
  const int steps = wmz::bd::q_steps(q0, L);
  auto issue = [&](int s) {
    bf16* stage = KV + (s & 1) * 2 * kKeys * Lp;
    const int k0 = wmz::bd::q_step_key(q0, L, s);
    mma::load_rows_async<D, kKeys>(stage, kb, sk.n, k0, N);
    mma::load_rows_async<D, kKeys>(stage + kKeys * Lp, vb, sv.n, k0, N);
  };
  mma::load_rows_async<D, kRows>(Qs, q + b * sq.b + h * sq.h, sq.n, q0, N);
  issue(0);
  mma::cp_async_commit();

  float acc[D / 8][4];
  mma::zero<D / 8>(acc);
  // this lane's rows row0 and row0 + 8: the running max and sum
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int row0 = q0 + 16 * warp + gr;
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) issue(s + 1);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();
    __syncthreads();
    const bf16* Ks = KV + (s & 1) * 2 * kKeys * Lp;
    const bf16* Vs = Ks + kKeys * Lp;
    const int k0 = wmz::bd::q_step_key(q0, L, s);
    const bool masked = wmz::bd::q_step_masked(q0, L, s);
#pragma unroll
    for (int c0 = 0; c0 < kKeys; c0 += kSub) {
      float sc[kSub / 8][4];
      mma::warp_dots<D, kSub>(Qs + 16 * warp * Lp, Ks + c0 * Lp, sc);
      float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < kSub / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + c0 + 8 * j + 2 * t + (e & 1), row = row0 + 8 * (e >> 1);
          sc[j][e] = !masked || wmz::bd::allowed(row, key, L, bs) ? sc[j][e] * scale
                                                                  : -INFINITY;
          mt[e >> 1] = fmaxf(mt[e >> 1], sc[j][e]);
        }
      float corr[2], ps[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m[i], mma::quad_max(mt[i]));
        // a row with no allowed key yet keeps m = -inf and acc = 0
        corr[i] = m_new == -INFINITY ? 1.f : __expf(m[i] - m_new);
        m[i] = m_new;
      }
#pragma unroll
      for (int j = 0; j < kSub / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const float p = m[i] == -INFINITY ? 0.f : __expf(sc[j][e] - m[i]);
          sc[j][e] = p;
          ps[i] += p;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + mma::quad_sum(ps[i]);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] *= corr[e >> 1];
      uint32_t pa[kSub / 16][4];
      mma::to_a_frags<kSub>(sc, pa);  // P to bf16
      mma::warp_product<D, kSub>(pa, Vs + c0 * Lp, acc);
    }
    __syncthreads();  // every warp is done with this stage before its refill
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float inv = __frcp_rn(l[i]);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) acc[j][2 * i] *= inv, acc[j][2 * i + 1] *= inv;
    if (t == 0) lse[((long long)b * H + h) * N + row0 + 8 * i] = m[i] + logf(l[i]);
  }
  mma::store_rows<D>(acc, out + ((long long)b * N * H + h) * D, (long long)H * D,
                     q0 + 16 * warp, N);
}

template <int D>
cudaError_t launch_bd(const void* q, const void* k, const void* v, void* out, float* lse,
                      const long long* st, int B, int H, int group, int N, int bs, float scale,
                      cudaStream_t stream) {
  const size_t bytes = mma::tile_bytes<D>(64 + 4 * wmz::bd::kTile);
  auto kernel = bdflash_fwd_kernel<D>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(N / 64), (unsigned)H, (unsigned)B);
  wmz::note_launch(kernel);
  kernel<<<grid, 128, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), lse, Strides{st[0], st[1], st[2]},
      Strides{st[3], st[4], st[5]}, Strides{st[6], st[7], st[8]}, H, group, N, N / 2, bs,
      scale);
  return cudaGetLastError();
}
}  // namespace

// strides: int64 [9], the b, h, n element strides of q, k, v. block: the
// stock kernel's key block (a multiple of 128); normalise: 1 when one
// block covers the padded N. dtype: 0 = float32 (flash_fwd_tf32_kernel, in
// split TF32 on the tensor cores; it ignores block and normalise), 1 =
// bfloat16 (flash_fwd_mma_kernel). Returns the launch's cudaError_t.
extern "C" int wmz_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, const long long* strides,
                             int B, int H, int N, int D, float scale, int block,
                             int normalise, int dtype, void* stream) {
  if (wmz::flash::bad_head_size(D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ls = static_cast<float*>(lse);
  if (dtype == 0) {
    if (D == 64) return (int)launch_tf32<64>(q, k, v, out, ls, strides, B, H, N, scale, st);
    return (int)launch_tf32<128>(q, k, v, out, ls, strides, B, H, N, scale, st);
  }
  if (dtype != 1 || block <= 0 || block % 128 || (normalise && block < N))
    return (int)cudaErrorInvalidValue;
#define WMZ_FLASH_FWD_MMA(DD, NN) \
  return (int)launch_mma<DD, NN>(q, k, v, out, ls, strides, B, H, N, scale, block, st)
  if (D == 64) {
    if (normalise) WMZ_FLASH_FWD_MMA(64, true);
    WMZ_FLASH_FWD_MMA(64, false);
  }
  if (normalise) WMZ_FLASH_FWD_MMA(128, true);
  WMZ_FLASH_FWD_MMA(128, false);
#undef WMZ_FLASH_FWD_MMA
}

// The block-diffusion GQA forward (bdflash_fwd_kernel), bf16, D = 128.
// strides: int64 [9], the b, h, n element strides of q, k, v; H: query
// heads, group: query heads a KV head; N = 2 L with L % 64 == 0; bs: the
// block, 64 % bs == 0. Returns the launch's cudaError_t.
extern "C" int wmz_bdflash_fwd(const void* q, const void* k, const void* v, void* out,
                               void* lse, const long long* strides, int B, int H, int group,
                               int N, int D, int bs, float scale, void* stream) {
  if (D != 128 || group < 1 || H % group || N % 128 || bs < 1 || 64 % bs)
    return (int)cudaErrorInvalidValue;
  return (int)launch_bd<128>(q, k, v, out, static_cast<float*>(lse), strides, B, H, group, N,
                             bs, scale, static_cast<cudaStream_t>(stream));
}

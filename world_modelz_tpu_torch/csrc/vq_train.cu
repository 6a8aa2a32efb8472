// Fused VQ search + EMA statistics of one tokenizer training step, for
// Hopper (sm_90a).
//
// Replaces world_modelz_tpu/kernels/vq_kernels.py: `_vq_train_kernel`
// (:146) as `vq_train_stats_pallas` (:206) launches it for
// `ops/vq.py:vq_apply_fused` (:250).
//
// What it computes. For x (N, D) f32 and a (K, D) f32 codebook:
//   idx[n] = argmin_k (|e_k|^2 - 2 x_n.e_k), ties to the lowest k (the
//            search of vq_search.cuh, shared with vq_encode.cu, so training
//            and encode pick the same code for every row);
//   q[n]   = e_idx[n] (an exact gather of the old codebook);
//   cnt[k] = #{n : idx[n] = k}, an exact integer held in f32;
//   err[k] = sum over those n of max(min_k dist + |x_n|^2, 0);
//   dw[k]  = sum over those n of x_n (raw input sums, (K, D)).
//
// What bounds it on the H100. At the training shape (N = 96 x 8 x 8 =
// 6,144 rows, K = 512, D = 64) the search is 2 N K D = 4.0e8 f32
// operations (~6.0 us at the 67 TFLOP/s f32 CUDA-core rate) against ~3.4
// MB of traffic (x in, q out, codebook, dw: ~1.0 us at 3.35 TB/s): bound by
// operations. The statistics add only O(N D).
//
// Design. The TPU kernel adds one tile's one-hot products into resident
// accumulators over its sequential grid; Hopper's blocks run in no order
// and float atomics would make the sums depend on it. Four launches, every
// sum in a fixed order, so two launches on one input give bitwise-equal
// cnt, err and dw:
//   1. prep: the transposed codebook and code norms (vq_search.cuh);
//   2. search: one CTA per 16 rows writes idx, q and each row's error;
//   3. stats: a code-centric pass. Block (g, s) owns codes
//      [8g, 8g + 8) and rows [1024s, 1024s + 1024); its 8 warps take
//      32-row chunks in turn, find their rows of the block's codes with a
//      ballot, and add each such row (in row order) into per-warp sums in
//      shared memory; the warps' sums are then folded in warp order into
//      the split's partial sums. Rows are read only by the block that owns
//      their code, so x is read once; a code with many rows is spread over
//      the splits and the warps;
//   4. fold: the splits' partials, added in split order.
// Counts are integers until the fold writes them as f32 (exact below
// 2^24). The longest chain of f32 adds for one sum is 128 rows of a warp +
// 8 warps + the splits: 142 at N = 6,144.

#include "vq_search.cuh"

namespace {

constexpr int kStatCodes = 8;      // codes per stats block
constexpr int kStatWarps = 8;      // warps per stats block
constexpr int kSplitRows = 1024;   // rows per stats split
constexpr int kFoldThreads = 256;

__global__ void __launch_bounds__(kThreads)
vq_train_search_kernel(const float* __restrict__ x,
                       const float* __restrict__ codebook,
                       const float* __restrict__ e_t,
                       const float* __restrict__ e_sq,
                       int32_t* __restrict__ idx, float* __restrict__ q,
                       float* __restrict__ err_row, int N, int K, int D) {
  __shared__ SearchSmem sm;
  __shared__ int k_s[kRows];
  const long long row0 = (long long)blockIdx.x * kRows;
  float best_d;
  int best_k;
  search_rows<float>(x, e_t, e_sq, N, K, D, row0, sm, best_d, best_k);
  if (threadIdx.x < kRows) {
    const int r = threadIdx.x;
    const long long row = row0 + r;
    float x_sq = 0.f;  // |x|^2 in d order from the staged row
    for (int d = 0; d < D; ++d) {
      const float v = sm.x_s[d * kXStride + r];
      x_sq = fmaf(v, v, x_sq);
    }
    k_s[r] = best_k;
    if (row < N) {
      idx[row] = best_k;
      err_row[row] = fmaxf(best_d + x_sq, 0.f);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const long long row = row0 + r;
    if (row < N) q[row * D + d] = codebook[(long long)k_s[r] * D + d];
  }
}

__global__ void __launch_bounds__(kStatWarps * 32)
vq_stats_kernel(const float* __restrict__ x, const int32_t* __restrict__ idx,
                const float* __restrict__ err_row,
                float* __restrict__ part_dw, int32_t* __restrict__ part_cnt,
                float* __restrict__ part_err, int N, int K, int D) {
  __shared__ float acc_dw[kStatWarps][kStatCodes][kMaxD];
  __shared__ float acc_err[kStatWarps][kStatCodes];
  __shared__ int acc_cnt[kStatWarps][kStatCodes];

  const int c0 = blockIdx.x * kStatCodes;
  const int split = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < kStatWarps * kStatCodes * kMaxD;
       i += blockDim.x)
    (&acc_dw[0][0][0])[i] = 0.f;
  if (threadIdx.x < kStatWarps * kStatCodes) {
    (&acc_err[0][0])[threadIdx.x] = 0.f;
    (&acc_cnt[0][0])[threadIdx.x] = 0;
  }
  __syncthreads();

  const long long r_begin = (long long)split * kSplitRows;
  const long long r_end = min((long long)N, r_begin + kSplitRows);
  for (long long base = r_begin + warp * 32; base < r_end;
       base += kStatWarps * 32) {
    const long long row = base + lane;
    const int code = row < r_end ? idx[row] - c0 : -1;
    const bool mine = code >= 0 && code < kStatCodes;
    const float e = mine ? err_row[row] : 0.f;
    unsigned m = __ballot_sync(0xffffffffu, mine);
    while (m) {  // this chunk's rows of the block's codes, in row order
      const int j = __ffs(m) - 1;
      m &= m - 1;
      const int c = __shfl_sync(0xffffffffu, code, j);
      const float ej = __shfl_sync(0xffffffffu, e, j);
      const float* xr = x + (base + j) * D;
      for (int d = lane; d < D; d += 32) acc_dw[warp][c][d] += xr[d];
      if (lane == 0) {
        acc_err[warp][c] += ej;
        acc_cnt[warp][c] += 1;
      }
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kStatCodes * D; i += blockDim.x) {
    const int c = i / D, d = i % D;
    if (c0 + c >= K) continue;
    float s = acc_dw[0][c][d];
    for (int w = 1; w < kStatWarps; ++w) s += acc_dw[w][c][d];
    part_dw[((long long)split * K + c0 + c) * D + d] = s;
  }
  if (threadIdx.x < kStatCodes && c0 + (int)threadIdx.x < K) {
    const int c = threadIdx.x;
    float s = acc_err[0][c];
    int n = acc_cnt[0][c];
    for (int w = 1; w < kStatWarps; ++w) {
      s += acc_err[w][c];
      n += acc_cnt[w][c];
    }
    part_err[(long long)split * K + c0 + c] = s;
    part_cnt[(long long)split * K + c0 + c] = n;
  }
}

__global__ void __launch_bounds__(kFoldThreads)
vq_fold_kernel(const float* __restrict__ part_dw,
               const int32_t* __restrict__ part_cnt,
               const float* __restrict__ part_err, float* __restrict__ cnt,
               float* __restrict__ err, float* __restrict__ dw, int splits,
               int K, int D) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long kd = (long long)K * D;
  if (i < kd) {
    float s = part_dw[i];
    for (int p = 1; p < splits; ++p) s += part_dw[p * kd + i];
    dw[i] = s;
  }
  if (i < K) {
    float s = part_err[i];
    int n = part_cnt[i];
    for (int p = 1; p < splits; ++p) {
      s += part_err[(long long)p * K + i];
      n += part_cnt[(long long)p * K + i];
    }
    err[i] = s;
    cnt[i] = (float)n;
  }
}

}  // namespace

// Number of row splits of the stats pass; the wrapper sizes the partial
// buffers with it.
extern "C" int wmz_vq_train_splits(int N) {
  return (N + kSplitRows - 1) / kSplitRows;
}

// x (N, D) and codebook (K, D) f32 in; idx (N,) int32, q (N, D), cnt (K,),
// err (K,), dw (K, D) f32 out. Scratch, allocated by the wrapper: e_t
// (D, K), e_sq (K,), err_row (N,) f32; part_dw (splits, K, D) f32,
// part_cnt (splits, K) int32, part_err (splits, K) f32 with splits =
// wmz_vq_train_splits(N). Returns the cudaError_t of the launches.
extern "C" int wmz_vq_train_stats(
    const void* x, const void* codebook, void* e_t, void* e_sq, void* idx,
    void* q, void* err_row, void* part_dw, void* part_cnt, void* part_err,
    void* cnt, void* err, void* dw, int N, int K, int D, void* stream) {
  if (N <= 0 || K <= 0 || D <= 0 || D > kMaxD) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* cb = static_cast<const float*>(codebook);
  float* et = static_cast<float*>(e_t);
  float* sq = static_cast<float*>(e_sq);
  int32_t* ix = static_cast<int32_t*>(idx);
  float* er = static_cast<float*>(err_row);
  cudaError_t status = launch_prep(cb, et, sq, K, D, st);
  if (status != cudaSuccess) return (int)status;
  wmz::note_launch(vq_train_search_kernel);
  vq_train_search_kernel<<<(N + kRows - 1) / kRows, kThreads, 0, st>>>(
      xf, cb, et, sq, ix, static_cast<float*>(q), er, N, K, D);
  status = cudaGetLastError();
  if (status != cudaSuccess) return (int)status;
  const int splits = wmz_vq_train_splits(N);
  const dim3 grid((K + kStatCodes - 1) / kStatCodes, splits);
  wmz::note_launch(vq_stats_kernel);
  vq_stats_kernel<<<grid, kStatWarps * 32, 0, st>>>(
      xf, ix, er, static_cast<float*>(part_dw),
      static_cast<int32_t*>(part_cnt), static_cast<float*>(part_err), N, K,
      D);
  status = cudaGetLastError();
  if (status != cudaSuccess) return (int)status;
  const long long kd = (long long)K * D;
  wmz::note_launch(vq_fold_kernel);
  vq_fold_kernel<<<(unsigned)((kd + kFoldThreads - 1) / kFoldThreads),
                   kFoldThreads, 0, st>>>(
      static_cast<const float*>(part_dw),
      static_cast<const int32_t*>(part_cnt),
      static_cast<const float*>(part_err), static_cast<float*>(cnt),
      static_cast<float*>(err), static_cast<float*>(dw), splits, K, D);
  return (int)cudaGetLastError();
}

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
// 6,144 rows, K = 512, D = 64) the search is 2 N K D = 4.0e8 operations,
// taken as three TF32 products each (split TF32, vq_search.cuh): 2.44 us at
// the 495 TFLOP/s TF32 rate (6.12 us for the same search on the f32 CUDA
// cores at 67), against ~3.4 MB of traffic (x in, q out, codebook, dw:
// ~1.0 us at 3.35 TB/s): bound by operations. The statistics add only
// O(N D).
//
// Design. The TPU kernel adds one tile's one-hot products into resident
// accumulators over its sequential grid; Hopper's blocks run in no order
// and float atomics would make the sums depend on it. Three launches,
// every sum in a fixed order, so two launches on one input give
// bitwise-equal idx, q, cnt, err and dw:
//   1. prep: the codebook's split planes and code norms (vq_search.cuh);
//   2. search: one CTA per 128-row tile and code split (vq_search.cuh); the
//      cluster's first CTA writes the tile's idx, q and each row's err =
//      max(min dist + |x|^2, 0), |x|^2 summed in f32 in d order;
//   3. statistics, code-centric, no cross-block sums: block g owns codes
//      [2 g, 2 g + 2) and walks every row. Its 16 warps take 32-row chunks
//      in turn, 16 chunks a round: a warp loads their codes, lists its rows
//      of the block's codes in row order (ballots, shared memory) and adds
//      them 8 at a time, the batch's loads issued first: a batch's rows of a
//      code are added in order into zeroed sums, which are added to the
//      warp's totals; the block adds the warps' totals in warp order.
// Counts are integers until written as f32 (exact below 2^24). No float
// atomics. The longest chain of f32 adds for one sum is 8 rows of a batch +
// the warp's batches (at most N / 128) + 16 warps: 72 at N = 6,144.

#include "vq_search.cuh"

namespace {

constexpr int kStatCodes = 2;    // codes of a statistics block
constexpr int kStatWarps = 16;   // its warps
constexpr int kStatThreads = kStatWarps * 32;
constexpr int kRound = 16;       // 32-row chunks a warp lists at a time
constexpr int kBatch = 8;        // listed rows whose loads are issued together

__global__ void __launch_bounds__(kThreads, 1)
vq_train_search_kernel(const float* __restrict__ x, const float* __restrict__ codebook,
                       Scratch s, int32_t* __restrict__ idx, float* __restrict__ q, int N,
                       int D, bool vec, int chunks, int per_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SearchSmem& sm = search_smem(smem_raw);
  search<float, true>(x, s.planes, s.e_sq, N, D, vec, chunks, per_split, sm,
                      [&](long long row0) {
    for (int r = threadIdx.x; r < kRows; r += kThreads) {
      const long long row = row0 + r;
      if (row >= N) continue;
      float x_sq = 0.f;  // |x|^2 in d order
#pragma unroll
      for (int d = 0; d < kMaxD; ++d)
        if (d < D) x_sq = fmaf(sm.x[r * kXStride + d], sm.x[r * kXStride + d], x_sq);
      idx[row] = sm.best_k[r];
      s.err_row[row] = fmaxf(sm.best_d[r] + x_sq, 0.f);
    }
    // q: the rows' codes, every load of a thread issued before its stores;
    // 16-byte vectors when the rows are kMaxD long and aligned
    constexpr int kGather = kRows * kMaxD / kThreads;
    if (vec && reinterpret_cast<uintptr_t>(codebook) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(q) % 16 == 0) {
      constexpr int kVecs = kGather / 4;
      float4 v[kVecs];
#pragma unroll
      for (int u = 0; u < kVecs; ++u) {
        const int i = threadIdx.x + u * kThreads, r = i / (kMaxD / 4);
        v[u] = row0 + r < N ? wmz::load4(codebook + (long long)sm.best_k[r] * kMaxD +
                                         (i % (kMaxD / 4)) * 4)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kVecs; ++u) {
        const int i = threadIdx.x + u * kThreads, r = i / (kMaxD / 4);
        if (row0 + r < N) wmz::store4(q + (row0 + r) * kMaxD + (i % (kMaxD / 4)) * 4, v[u]);
      }
    } else {
      for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
        const int r = i / D;
        if (row0 + r < N) q[(row0 + r) * D + i % D] = codebook[(long long)sm.best_k[r] * D + i % D];
      }
    }
  });
}

// Block g owns codes [kStatCodes g, kStatCodes (g + 1)) and walks every row.
// Warp w takes the 32-row chunks w, w + kStatWarps, ..., kRound chunks a
// round: it loads their codes, lists its rows of the block's codes in row
// order (shared memory), and adds them kBatch at a time, each batch's loads
// issued first: a batch's rows of a code are added in order into zeroed
// sums, which are added to the warp's totals. Each lane holds dims lane and
// lane + 32. The block then adds the warps' totals in warp order.
__global__ void __launch_bounds__(kStatThreads)
vq_stats_kernel(const float* __restrict__ x, const int32_t* __restrict__ idx,
                const float* __restrict__ err_row, float* __restrict__ cnt,
                float* __restrict__ err, float* __restrict__ dw, int N, int K, int D) {
  constexpr int kH = kMaxD / 32;  // dims of a lane
  // each warp's list of rows; after the walk, the warps' totals
  __shared__ union {
    int list_row[kStatWarps][kRound * 32];
    float tot_dw[kStatWarps][kStatCodes][kMaxD];
  } sh;
  __shared__ int8_t list_code[kStatWarps][kRound * 32];
  __shared__ float tot_err[kStatWarps][kStatCodes];
  __shared__ int tot_cnt[kStatWarps][kStatCodes];
  auto& list_row = sh.list_row;
  auto& tot_dw = sh.tot_dw;

  const int c0 = blockIdx.x * kStatCodes;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunks = (N + 31) / 32;
  const int my_chunks = (chunks - warp + kStatWarps - 1) / kStatWarps;
  float w_dw[kStatCodes][kH] = {}, w_err[kStatCodes] = {};
  int w_cnt[kStatCodes] = {};
  for (int r0 = 0; r0 < my_chunks; r0 += kRound) {
    int code[kRound];
#pragma unroll
    for (int u = 0; u < kRound; ++u) {
      const long long row = ((long long)(r0 + u) * kStatWarps + warp) * 32 + lane;
      code[u] = r0 + u < my_chunks && row < N ? idx[row] - c0 : -1;
    }
    int n = 0;
#pragma unroll
    for (int u = 0; u < kRound; ++u) {
      const bool mine = code[u] >= 0 && code[u] < kStatCodes;
      const unsigned m = __ballot_sync(0xffffffffu, mine);
      if (mine) {
        const int at = n + __popc(m & ((1u << lane) - 1u));
        list_row[warp][at] = ((r0 + u) * kStatWarps + warp) * 32 + lane;
        list_code[warp][at] = (int8_t)code[u];
      }
      n += __popc(m);
    }
    __syncwarp();
    for (int i = 0; i < n; i += kBatch) {
      int c[kBatch];
      float xv[kBatch][kH], ev[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        c[b] = i + b < n ? list_code[warp][i + b] : -1;
        const long long row = i + b < n ? list_row[warp][i + b] : 0;
#pragma unroll
        for (int h = 0; h < kH; ++h) {
          const int d = lane + 32 * h;
          xv[b][h] = c[b] >= 0 && d < D ? x[row * D + d] : 0.f;
        }
        ev[b] = c[b] >= 0 ? err_row[row] : 0.f;
      }
#pragma unroll
      for (int cc = 0; cc < kStatCodes; ++cc) {
        float g_dw[kH] = {}, g_err = 0.f;
        int g_cnt = 0;
#pragma unroll
        for (int b = 0; b < kBatch; ++b)
          if (c[b] == cc) {
#pragma unroll
            for (int h = 0; h < kH; ++h) g_dw[h] += xv[b][h];
            g_err += ev[b];
            g_cnt += 1;
          }
#pragma unroll
        for (int h = 0; h < kH; ++h) w_dw[cc][h] += g_dw[h];
        w_err[cc] += g_err;
        w_cnt[cc] += g_cnt;
      }
    }
    __syncwarp();  // the list is read before the next round writes it
  }
  __syncthreads();  // every list is read before the totals take its place
#pragma unroll
  for (int cc = 0; cc < kStatCodes; ++cc) {
#pragma unroll
    for (int h = 0; h < kH; ++h) tot_dw[warp][cc][lane + 32 * h] = w_dw[cc][h];
    if (lane == 0) {
      tot_err[warp][cc] = w_err[cc];
      tot_cnt[warp][cc] = w_cnt[cc];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kStatCodes * D; i += kStatThreads) {
    const int c = i / D, d = i % D;
    if (c0 + c >= K) continue;
    float sum = tot_dw[0][c][d];
    for (int w = 1; w < kStatWarps; ++w) sum += tot_dw[w][c][d];
    dw[(long long)(c0 + c) * D + d] = sum;
  }
  if (threadIdx.x < kStatCodes && c0 + (int)threadIdx.x < K) {
    const int c = threadIdx.x;
    float sum = tot_err[0][c];
    int n = tot_cnt[0][c];
    for (int w = 1; w < kStatWarps; ++w) {
      sum += tot_err[w][c];
      n += tot_cnt[w][c];
    }
    err[c0 + c] = sum;
    cnt[c0 + c] = (float)n;
  }
}

}  // namespace

// x (N, D) and codebook (K, D) f32 in; idx (N,) int32, q (N, D), cnt (K,),
// err (K,), dw (K, D) f32 out. scratch: wmz_vq_scratch_bytes(N, K, 1)
// bytes, 256-byte aligned. Returns the cudaError_t of the launches.
extern "C" int wmz_vq_train_stats(const void* x, const void* codebook, void* scratch, void* idx,
                                  void* q, void* cnt, void* err, void* dw, int N, int K, int D,
                                  void* stream) {
  if (N <= 0 || K <= 0 || D <= 0 || D > kMaxD) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* cb = static_cast<const float*>(codebook);
  int32_t* ix = static_cast<int32_t*>(idx);
  Plan p;
  cudaError_t status = make_plan(N, K, p);
  if (status != cudaSuccess) return (int)status;
  const Scratch s = carve(static_cast<char*>(scratch), p.chunks, N, true);
  status = launch_prep(cb, s, p, K, D, st);
  if (status != cudaSuccess) return (int)status;
  status = launch_search<vq_train_search_kernel>(p, st, xf, cb, s, ix, static_cast<float*>(q), N,
                                                 D, vector_rows<float>(x, D), p.chunks,
                                                 p.per_split);
  if (status != cudaSuccess) return (int)status;
  wmz::note_launch(vq_stats_kernel);
  vq_stats_kernel<<<(K + kStatCodes - 1) / kStatCodes, kStatThreads, 0, st>>>(
      xf, ix, s.err_row, static_cast<float*>(cnt), static_cast<float*>(err),
      static_cast<float*>(dw), N, K, D);
  return (int)cudaGetLastError();
}

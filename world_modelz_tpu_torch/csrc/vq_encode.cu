// VQ nearest-code search, for Hopper (sm_90a).
//
// Replaces the index-only form of world_modelz_tpu/kernels/vq_kernels.py:
// `_vq_kernel` (:34) as `vq_encode_pallas` (:69) launches it with
// `return_quantized=False` (:129) for tokenizer encode
// (models/tokenizer.py:227-236).
//
// What it computes. For each row x of (N, D): argmin_k (|e_k|^2 - 2 x.e_k)
// over the (K, D) f32 codebook; ties go to the lowest k, as jnp.argmin
// does. Output is int32 (N,). The search itself lives in vq_search.cuh,
// shared with the training kernel (vq_train.cu), so encode and training
// pick the same code for every row.
//
// What bounds it on the H100. At K = 512, D = 64 the search is 2 N K D
// operations, taken as three TF32 products each for an f32 x (split TF32,
// vq_search.cuh): 3 x 2 N K D at the 495 TFLOP/s TF32 rate, 1.22 us at the
// serving encode (N = 3,072), 9.76 us at the denoiser step's (N = 24,576),
// 26.0 us at the sparse trainer's (N = 65,536), against N (4 D + 4) + 4 K D
// bytes of traffic (5.1 us at 3.35 TB/s at N = 65,536): bound by
// operations. A bf16 x takes two TF32 products.
//
// Design. Two launches: the prep kernel (the codebook's split planes and
// code norms) and vq_encode_kernel, one CTA per 128-row tile and code
// split, a tile's splits one cluster (vq_search.cuh); the cluster's first
// CTA writes the tile's indices.

#include "vq_search.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
vq_encode_kernel(const T* __restrict__ x, Scratch s, int32_t* __restrict__ idx, int N, int D,
                 bool vec, int chunks, int per_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SearchSmem& sm = search_smem(smem_raw);
  search<T, false>(x, s.planes, s.e_sq, N, D, vec, chunks, per_split, sm,
                   [&](long long row0) {
                     for (int r = threadIdx.x; r < kRows; r += kThreads)
                       if (row0 + r < N) idx[row0 + r] = sm.best_k[r];
                   });
}

template <typename T>
cudaError_t launch(const void* x, const float* codebook, void* scratch, int32_t* idx, int N,
                   int K, int D, cudaStream_t stream) {
  Plan p;
  cudaError_t err = make_plan(N, K, p);
  if (err != cudaSuccess) return err;
  const Scratch s = carve(static_cast<char*>(scratch), p.chunks, N, false);
  err = launch_prep(codebook, s, p, K, D, stream);
  if (err != cudaSuccess) return err;
  return launch_search<vq_encode_kernel<T>>(p, stream, static_cast<const T*>(x), s, idx, N, D,
                                            vector_rows<T>(x, D), p.chunks, p.per_split);
}

}  // namespace

// Bytes of device scratch that wmz_vq_encode (train = 0) or
// wmz_vq_train_stats (train = 1) takes for N rows of a (K, D) codebook.
extern "C" long long wmz_vq_scratch_bytes(int N, int K, int train) {
  return (long long)carve(nullptr, chunks_of(K), N, train != 0).bytes;
}

// x_dtype: 0 = float32, 1 = bfloat16; the codebook is always float32.
// scratch: wmz_vq_scratch_bytes(N, K, 0) bytes, 256-byte aligned.
// Returns the cudaError_t of the launches.
extern "C" int wmz_vq_encode(const void* x, const void* codebook, void* scratch, void* idx,
                             int N, int K, int D, int x_dtype, void* stream) {
  if (N <= 0 || K <= 0 || D <= 0 || D > kMaxD) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* cb = static_cast<const float*>(codebook);
  int32_t* out = static_cast<int32_t*>(idx);
  cudaError_t err;
  if (x_dtype == 0) {
    err = launch<float>(x, cb, scratch, out, N, K, D, st);
  } else if (x_dtype == 1) {
    err = launch<__nv_bfloat16>(x, cb, scratch, out, N, K, D, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

extern "C" const char* wmz_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

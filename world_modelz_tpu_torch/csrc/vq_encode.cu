// VQ nearest-code search, for Hopper (sm_90a).
//
// Replaces the index-only form of world_modelz_tpu/kernels/vq_kernels.py:
// `_vq_kernel` (:34) as `vq_encode_pallas` (:69) launches it with
// `return_quantized=False` (:129) for tokenizer encode
// (models/tokenizer.py:227-236).
//
// What it computes. For each row x of (N, D): argmin_k (|e_k|^2 - 2 x.e_k)
// over the (K, D) f32 codebook, accumulated in f32; ties go to the lowest k,
// as jnp.argmin does. Output is int32 (N,). The search itself lives in
// vq_search.cuh, shared with the training kernel (vq_train.cu), so encode
// and training pick the same code for every row.
//
// What bounds it on the H100. At the serving encode batch (N = 8 clips x 6
// frames x 64 tokens = 3,072 rows, K = 512, D = 64) the work is ~201 MFLOP
// (~3 us at the 67 TFLOP/s f32 CUDA-core rate) against ~0.9 MB of traffic
// (~0.3 us at 3.35 TB/s): bound by f32 operations. Index parity with the
// plain version depends on f32 distances, so no TF32 or bf16 tensor-core
// products are used.
//
// Design. Two launches: the prep kernel (transposed codebook and code
// norms) and one CTA of search_rows per 16 rows. 3,072 rows give 192 CTAs,
// more than the 132 SMs.

#include "vq_search.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads)
vq_encode_kernel(const T* __restrict__ x, const float* __restrict__ e_t,
                 const float* __restrict__ e_sq, int32_t* __restrict__ idx,
                 int N, int K, int D) {
  __shared__ SearchSmem sm;
  const long long row0 = (long long)blockIdx.x * kRows;
  float best_d;
  int best_k;
  search_rows<T>(x, e_t, e_sq, N, K, D, row0, sm, best_d, best_k);
  if (threadIdx.x < kRows && row0 + threadIdx.x < N)
    idx[row0 + threadIdx.x] = best_k;
}

template <typename T>
cudaError_t launch(const void* x, const float* codebook, float* e_t,
                   float* e_sq, int32_t* idx, int N, int K, int D,
                   cudaStream_t stream) {
  cudaError_t err = launch_prep(codebook, e_t, e_sq, K, D, stream);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((N + kRows - 1) / kRows)), block(kThreads);
  wmz::note_launch(vq_encode_kernel<T>);
  vq_encode_kernel<T><<<grid, block, 0, stream>>>(
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

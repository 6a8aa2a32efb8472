// Split TF32 (sm_80 and later): an f32 product on the tensor cores as three
// TF32 products. x = hi + lo with hi = tf32(x) and lo = tf32(x - hi), each
// rounded to nearest with ties away (cvt.rna); a b is taken as lo_a hi_b +
// hi_a lo_b + hi_a hi_b, small terms first (lo_a lo_b, ~2^-22 relative, is
// dropped). The split of the f32 flash forward (flash_fwd.cu, on mma.sync)
// and of the VQ search (vq_search.cuh, on wgmma).
#pragma once

#include <cuda_runtime.h>

#include <stdint.h>

namespace wmz {
namespace split_tf32 {

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// the low 13 bits of hi are cleared so that x - hi is exact
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x) & 0xffffe000u;
  lo = to_tf32(x - __uint_as_float(hi));
}

}  // namespace split_tf32
}  // namespace wmz

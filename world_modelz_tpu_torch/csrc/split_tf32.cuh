// Split TF32 (sm_80 and later): an f32 product on the tensor cores as three
// TF32 products. x = hi + lo with hi = tf32(x) and lo = tf32(x - hi), each
// rounded to nearest with ties away (cvt.rna); a b is taken as lo_a hi_b +
// hi_a lo_b + hi_a hi_b, small terms first (lo_a lo_b, ~2^-22 relative, is
// dropped). The split of the f32 flash forward (flash_fwd.cu, on mma.sync)
// and of the VQ search (vq_search.cuh, on wgmma); split_int, the same
// values by integer operations, of the dense layers (dense_tf32.cu).
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

// tf32(x) as cvt.rna rounds a finite x, on the bits: the magnitude
// rounded at bit 13 to nearest, ties away from zero, the low 13 bits
// cleared
__device__ __forceinline__ uint32_t round_bits(uint32_t b) { return (b + 0x1000u) & 0xffffe000u; }
// split's hi and lo by integer adds and masks instead of cvt, for a kernel
// that splits every operand value as it arrives (dense_tf32.cu), where the
// conversions were too slow (PERF.md, the dense kernel's row). An x of
// exponent 255 (inf, NaN) is its own hi, so the products carry it; lo
// then needs no such guard.
__device__ __forceinline__ void split_int(float x, uint32_t& hi, uint32_t& lo) {
  const uint32_t b = __float_as_uint(x);
  hi = (b & 0x7f800000u) == 0x7f800000u ? b : round_bits(b);
  lo = round_bits(__float_as_uint(x - __uint_as_float(hi)));
}

}  // namespace split_tf32
}  // namespace wmz

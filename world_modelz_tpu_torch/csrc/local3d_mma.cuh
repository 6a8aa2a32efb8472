// The local-3D window on flash_mma.cuh's tensor-core tiles, for the bf16
// forward (local3d_fwd.cu) and backward (local3d_bwd.cu).
//
// Positions p = h * W + w of a frame are row-major, so the keys a run of
// query positions [p0, p1) can see in any frame of its window lie in one
// contiguous run of positions: the whole rows within eh of theirs
// (`key_band`, the JAX package's `_band_bounds`, local3d.py:408). A block
// stages that run of each frame in 64-position tiles, and each warp masks
// the keys of a tile outside each of its queries' windows (`in_window`).
#pragma once

#include <cuda_runtime.h>

namespace wmz {
namespace l3d {

constexpr int kTileKeys = 64;  // key positions of a staged tile

// key positions [lo, hi) of a frame that query positions [p0, p1) of an
// H x W frame can see: rows max(h(p0) - eh, 0) .. min(h(p1 - 1) + eh, H - 1)
struct Band {
  int lo, hi;
};
__device__ __forceinline__ Band key_band(int p0, int p1, int H, int W, int eh) {
  const int h0 = max(p0 / W - eh, 0), h1 = min((p1 - 1) / W + eh, H - 1);
  return Band{h0 * W, (h1 + 1) * W};
}

// whether key position pk of a frame lies in the spatial window of the
// query at (hq, wq); keys of the clip's other frames share the test
__device__ __forceinline__ bool in_window(int pk, int hq, int wq, int W, int eh, int ew) {
  const int hk = pk / W, wk = pk - hk * W;
  return abs(hk - hq) <= eh && abs(wk - wq) <= ew;
}

}  // namespace l3d
}  // namespace wmz

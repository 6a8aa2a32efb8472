// The local-3D window and the warp layout shared by the forward kernel
// (local3d_fwd.cu), the backward pair (local3d_bwd.cu) and the attention
// phase of the fused block (local3d_block.cu).
//
// Rows are the (b, s, h, w, head) positions of a (B, S, H, W, heads * dh)
// tensor, head fastest: row r's elements start at r * dh. The window of row
// (b, s, h, w, head) holds the rows of the same b and head with |ds| <= es
// inside the clip, |dh| <= eh and |dw| <= ew inside the frame. It is
// symmetric: j lies in i's window exactly when i lies in j's, which is what
// lets the dK/dV pass walk a key's window to find the queries that see it.
//
// One warp serves one centre row, split into kGroups groups of kGroupLanes
// lanes; group g takes rows g, g + kGroups, ... of the window in row-major
// (s, h, w) order. Lane t of a group holds elements [t*E, t*E+E) of a row,
// dh = kGroupLanes * E.
#pragma once

#include <cuda_runtime.h>

namespace wmz {

constexpr int kWarpsPerBlock = 4;
constexpr int kGroupLanes = 8;             // lanes that share one row
constexpr int kGroups = 32 / kGroupLanes;  // rows in flight per warp

// A centre row and the bounds of its window.
struct Window {
  int b, s, h, w, head;
  int s0, h0, w0, nw, nhw, n;  // first (s, h, w), widths, row count
};

__device__ __forceinline__ Window window_of(long long row, int S, int H, int W,
                                            int heads, int es, int eh,
                                            int ew) {
  Window c;
  long long r = row;
  c.head = (int)(r % heads);
  r /= heads;
  c.w = (int)(r % W);
  r /= W;
  c.h = (int)(r % H);
  r /= H;
  c.s = (int)(r % S);
  c.b = (int)(r / S);
  c.s0 = max(c.s - es, 0);
  const int s1 = min(c.s + es, S - 1);
  c.h0 = max(c.h - eh, 0);
  const int h1 = min(c.h + eh, H - 1);
  c.w0 = max(c.w - ew, 0);
  const int w1 = min(c.w + ew, W - 1);
  c.nw = w1 - c.w0 + 1;
  c.nhw = (h1 - c.h0 + 1) * c.nw;
  c.n = (s1 - c.s0 + 1) * c.nhw;  // never 0: the centre is in its window
  return c;
}

// the (b, s, h, w) position of the i-th element of the window, i < n
__device__ __forceinline__ long long window_pos(const Window& c, int i, int S,
                                                int H, int W) {
  const int ss = c.s0 + i / c.nhw;
  const int hh = c.h0 + (i % c.nhw) / c.nw;
  const int ww = c.w0 + i % c.nw;
  return (((long long)c.b * S + ss) * H + hh) * W + ww;
}

// the row of the i-th element of the window, i < n
__device__ __forceinline__ long long window_row(const Window& c, int i, int S,
                                                int H, int W, int heads) {
  return window_pos(c, i, S, H, W) * heads + c.head;
}

// the (b, s, h, w) position of the centre row
__device__ __forceinline__ long long centre_pos(const Window& c, int S, int H,
                                                int W) {
  return (((long long)c.b * S + c.s) * H + c.h) * W + c.w;
}

// sum over the kGroupLanes lanes of a group; all 32 lanes take part
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = kGroupLanes / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// blocks of kWarpsPerBlock warps, one warp per row
inline unsigned blocks_for(int B, int S, int H, int W, int heads) {
  const long long rows = (long long)B * S * H * W * heads;
  return (unsigned)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

// the head sizes the kernels are instantiated for
inline bool bad_dh(int dh) { return dh % 32 != 0 || dh < 32 || dh > 256; }

}  // namespace wmz

// switch (dh / kGroupLanes) over the instantiated E, CASE(E) per value;
// any other head size returns cudaErrorInvalidValue
#define WMZ_L3D_E_SWITCH(dh, CASE)        \
  switch ((dh) / wmz::kGroupLanes) {      \
    CASE(4)                               \
    CASE(8)                               \
    CASE(12)                              \
    CASE(16)                              \
    CASE(20)                              \
    CASE(24)                              \
    CASE(28)                              \
    CASE(32)                              \
    default:                              \
      return cudaErrorInvalidValue;       \
  }

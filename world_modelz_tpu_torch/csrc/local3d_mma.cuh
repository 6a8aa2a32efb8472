// The local-3D window on flash_mma.cuh's tensor-core tiles, for the bf16
// forward (local3d_fwd.cu), the fused block's attention phase
// (local3d_block.cu), which both run `fwd_block`, and the backward
// (local3d_bwd.cu).
//
// Positions p = h * W + w of a frame are row-major, so the keys a run of
// query positions [p0, p1) can see in any frame of its window lie in one
// contiguous run of positions: the whole rows within eh of theirs
// (`key_band`, the JAX package's `_band_bounds`, local3d.py:408). A block
// stages that run of each frame in 64-position tiles, and each warp masks
// the keys of a tile outside each of its queries' windows (`in_window`).
#pragma once

#include <cuda_runtime.h>

#include <stdint.h>

#include <type_traits>

#include "flash_mma.cuh"

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

// The shape of fwd_block's block for a (B, S, H, W) clip of `heads` heads
// on `sms` SMs: 4 query warps (64 positions), or 2 where the key band of 64
// positions would not fit one tile (16 x 16 frames: 6 rows of 16 against
// 4), so that every block stages one tile a frame; one group of warps, or
// two where the work items fit the SMs at once (the serving shape: 48),
// so that each block's chain of steps is half as long.
struct FwdShape {
  int warps, groups;
};
inline FwdShape fwd_shape(int B, int S, int H, int W, int heads, int eh, int sms) {
  const int rows64 = min((min(64, H * W) - 1) / W + 1 + 2 * eh, H);
  const int warps = rows64 * W <= kTileKeys ? 4 : 2;
  const long long items = (long long)(H * W + 16 * warps - 1) / (16 * warps) * S * B * heads;
  return FwdShape{warps, items <= sms ? 2 : 1};
}

// shared-memory bytes of fwd_block: two stages of 2 kGroups tiles; with
// more than one group, a ring of 2 kGroups V tiles and the groups' (m, l)
template <int D, int kWarps, int kGroups>
constexpr size_t fwd_smem_bytes() {
  return mma::tile_bytes<D>((kGroups > 1 ? 6 : 4) * kGroups * kTileKeys) +
         (kGroups > 1 ? 2 * kGroups * 16 * kWarps * sizeof(float) : 0);
}

// One block of the bf16 forward (local3d_fwd.cu): the 16 kWarps query
// positions from pb * 16 kWarps of frame s of (b, head), against their
// window, with P rounded where the TPU kernel rounds it (kDivideAfter:
// route 1, else route 2). q, k and v are read at row stride ld_in
// elements between positions, out written at ld_out; each points at head
// 0 of position 0. Every thread of the block (32 kWarps kGroups) takes
// part, with `smem_raw` of fwd_smem_bytes. kGroups groups of kWarps
// warps split the window's tiles: each group takes its share of every
// step, and the groups merge their maxima (and sums) after sweep 1 and
// their P V sums at the end, in group order. Group 0 alone writes out: a
// caller that reuses `smem_raw` syncs the block first.
template <int D, int kWarps, int kGroups, bool kDivideAfter>
__device__ __forceinline__ void fwd_block(const mma::bf16* __restrict__ q,
                                          const mma::bf16* __restrict__ k,
                                          const mma::bf16* __restrict__ v, long long ld_in,
                                          mma::bf16* __restrict__ out, long long ld_out, int S,
                                          int H, int W, int heads, int es, int eh, int ew,
                                          float scale, int pb, int s, int b, int head,
                                          unsigned char* smem_raw) {
  using mma::bf16;
  constexpr int kOwn = 16 * kWarps, L = D + mma::kPad;
  // a stage holds 2 kGroups tiles of kTileKeys rows: sweep 1 stages that
  // many K tiles (two per group), sweep 2 a K tile and its V tile per
  // group. With more than one group a ring of two stages of kGroups V
  // tiles follows: where the window has at most 4 kGroups K tiles, sweep 1
  // leaves all of them in the two stages and sweep 2 stages V alone
  constexpr int kUnit = kTileKeys * L, kStage = 2 * kGroups * kUnit;
  constexpr int kRing = kGroups > 1 ? 2 * kGroups * kUnit : 0;
  bf16* KV = reinterpret_cast<bf16*>(smem_raw);  // two stages
  bf16* Vring = KV + 2 * kStage;
  const int HW = H * W;
  const int p0 = pb * kOwn, p1 = min(p0 + kOwn, HW);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qw = warp % kWarps, grp = warp / kWarps;  // query sub-block, group
  const int gr = lane >> 2, t = lane & 3;
  // element offset of head `head` of frame f's first position
  auto frame = [&](int f, long long ld) { return ((long long)b * S + f) * HW * ld + head * D; };
  const wmz::l3d::Band band = wmz::l3d::key_band(p0, p1, H, W, eh);
  const int tiles = (band.hi - band.lo + kTileKeys - 1) / kTileKeys;
  const int f0 = max(s - es, 0), frames = min(s + es, S - 1) - f0 + 1;
  // the window's K tiles kt = 0 .. n - 1, frame by frame; sweep 1 takes
  // 2 kGroups of them a step, sweep 2 kGroups (with their V tiles)
  // with more than one group and at most 4 kGroups tiles, sweep 1 is one
  // step that stages every K tile (all stay resident for sweep 2)
  const int n = frames * tiles;
  const bool resident = kGroups > 1 && n <= 4 * kGroups;
  const int n1 = resident ? 1 : (n + 2 * kGroups - 1) / (2 * kGroups);
  const int steps = n1 + (n + kGroups - 1) / kGroups;
  // where K tile kt stays in resident mode
  auto resident_k = [&](int kt) {
    return KV + kt / (2 * kGroups) * kStage + kt % (2 * kGroups) * kUnit;
  };
  auto load = [&](bf16* dst, const bf16* src, int kt) {
    const int t0 = band.lo + kt % tiles * kTileKeys;
    mma::load_rows_async<D, kTileKeys>(dst, src + frame(f0 + kt / tiles, ld_in), ld_in, t0,
                                       band.hi);
  };
  auto issue = [&](int i) {
    bf16* stage = KV + (i & 1) * kStage;
    if (resident && i == 0) {
      for (int kt = 0; kt < n; ++kt) load(resident_k(kt), k, kt);
      return;
    }
    for (int u = 0; u < 2 * kGroups; ++u) {
      if (i < n1) {
        if (2 * kGroups * i + u < n) load(stage + u * kUnit, k, 2 * kGroups * i + u);
      } else if (resident) {
        const int kt = kGroups * (i - n1) + u;
        if (u < kGroups && kt < n) load(Vring + ((i - n1) & 1) * kGroups * kUnit + u * kUnit, v, kt);
      } else {
        const int kt = kGroups * (i - n1) + u / 2;
        if (kt < n) load(stage + u * kUnit, u & 1 ? v : k, kt);
      }
    }
  };

  // Q into stage 1 (resident: the V ring's second slot, first written by
  // sweep 2's second step) and step 0; Q's fragments into registers
  bf16* Qs = resident ? Vring + kGroups * kUnit : KV + kStage;
  mma::load_rows_async<D, kOwn>(Qs, q + frame(s, ld_in), ld_in, p0, p1);
  issue(0);
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[D / 16][4];
  mma::load_a_frags<D>(Qs + 16 * qw * L, qa);
  __syncthreads();

  // this lane's query rows gr and gr + 8 of the warp's 16
  int hq[2], wq[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int pq = p0 + 16 * qw + gr + 8 * i;
    hq[i] = pq / W;
    wq[i] = pq - hq[i] * W;
  }
  // which of this lane's scores of KW keys from position t0 lie in their
  // query's window (bit 4 j + e of the m16n8 tile j, element e);
  // positions at or past the band's end are off the frame
  auto window_bits = [&](int t0, auto kw) {
    constexpr int KW = decltype(kw)::value;
    uint32_t bits = 0;
#pragma unroll
    for (int j = 0; j < KW / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int pk = t0 + 8 * j + 2 * t + c;
        if (pk >= band.hi) continue;
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (wmz::l3d::in_window(pk, hq[i], wq[i], W, eh, ew)) bits |= 1u << (4 * j + 2 * i + c);
      }
    return bits;
  };
  using Full = std::integral_constant<int, kTileKeys>;
  using Narrow = std::integral_constant<int, kTileKeys / 2>;
  // where the band is one tile and this warp's own key band (the rows
  // within eh of its 16 queries' rows) fits in half a tile, the warp takes
  // its products over that half only, from row `off` of the tile
  const wmz::l3d::Band wband =
      wmz::l3d::key_band(p0 + 16 * qw, max(min(p0 + 16 * qw + 16, p1), p0 + 16 * qw + 1), H, W, eh);
  const bool narrow = tiles == 1 && wband.hi - wband.lo <= kTileKeys / 2;
  const int off = narrow ? min(wband.lo - band.lo, kTileKeys / 2) : 0;
  // one tile's bits serve every frame
  const uint32_t bits0 = narrow ? window_bits(band.lo + off, Narrow{})
                                : window_bits(band.lo, Full{});
  float acc[D / 8][4];
  mma::zero<D / 8>(acc);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  // one K tile kt from stage rows Ks (and V from Vs): S = Q K^T over KW
  // keys from row `off`, scaled (rounded apart from the exponent's
  // subtraction) and -inf outside the window; sweep 1 folds it into the
  // row max (route 2: and the online sum), sweep 2 forms P = exp(s - m),
  // rounds it where the TPU kernel does and adds P V
  auto tile = [&](auto kw, const bf16* Ks, const bf16* Vs, int kt, bool sweep2) {
    constexpr int KW = decltype(kw)::value;
    float sc[KW / 8][4];
    mma::warp_dots_frags<D, KW>(qa, Ks + off * L, sc);
    const uint32_t bits =
        tiles == 1 ? bits0 : window_bits(band.lo + kt % tiles * kTileKeys, Full{});
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < KW / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = bits >> (4 * j + e) & 1u ? __fmul_rn(sc[j][e], scale) : -INFINITY;
        mt[e >> 1] = fmaxf(mt[e >> 1], sc[j][e]);
      }
    if (!sweep2) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m[i], mma::quad_max(mt[i]));
        if (!kDivideAfter && m_new != -INFINITY) {
          float ps = 0.f;
#pragma unroll
          for (int j = 0; j < KW / 8; ++j)
            ps += __expf(sc[j][2 * i] - m_new) + __expf(sc[j][2 * i + 1] - m_new);
          l[i] = (m[i] == -INFINITY ? 0.f : l[i] * __expf(m[i] - m_new)) + mma::quad_sum(ps);
        }
        m[i] = m_new;
      }
      return;
    }
#pragma unroll
    for (int j = 0; j < KW / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float p = __expf(__fsub_rn(sc[j][e], m[i]));
        if (kDivideAfter) {
          l[i] += p;
          sc[j][e] = p;
        } else {
          sc[j][e] = __fmul_rn(p, l[i]);  // l holds 1 / l here
        }
      }
    uint32_t pa[KW / 16][4];
    mma::to_a_frags<KW>(sc, pa);  // P to bf16 (local3d.py:536, :210)
    mma::warp_product<D, KW>(pa, Vs + off * L, acc);
  };
  auto run = [&](const bf16* Ks, const bf16* Vs, int kt, bool sweep2) {
    if (narrow)
      tile(Narrow{}, Ks, Vs, kt, sweep2);
    else
      tile(Full{}, Ks, Vs, kt, sweep2);
  };
  // the groups' (m, l) of each query row, and after sweep 2 their P V sums
  float* stats = reinterpret_cast<float*>(smem_raw + (2 * kStage + kRing) * sizeof(bf16));
  for (int it = 0; it < steps; ++it) {
    if (it + 1 < steps) issue(it + 1);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();
    __syncthreads();
    const bf16* stage = KV + (it & 1) * kStage;
    if (it < n1) {  // sweep 1: the max over the window (route 2: and the sum)
      if (resident) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int kt = grp + kGroups * u;
          if (kt < n) run(resident_k(kt), nullptr, kt, false);
        }
      } else {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int kt = 2 * kGroups * it + 2 * grp + u;
          if (kt < n) run(stage + (2 * grp + u) * kUnit, nullptr, kt, false);
        }
      }
      if (it == n1 - 1) {  // sweep 1 done: merge the groups' (m, l)
        if (kGroups > 1) {
          if (t == 0) {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              float* st = stats + 2 * (grp * kOwn + 16 * qw + gr + 8 * i);
              st[0] = m[i];
              st[1] = l[i];
            }
          }
          __syncthreads();
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int row = 16 * qw + gr + 8 * i;
            float mg = -INFINITY, lg = 0.f;
            for (int g = 0; g < kGroups; ++g) mg = fmaxf(mg, stats[2 * (g * kOwn + row)]);
            for (int g = 0; g < kGroups; ++g) {
              const float* st = stats + 2 * (g * kOwn + row);
              if (st[0] != -INFINITY) lg += st[1] * __expf(st[0] - mg);
            }
            m[i] = mg;
            l[i] = lg;
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (m[i] == -INFINITY) m[i] = 0.f;  // a row past the frame: no keys
          // route 1 sums P in sweep 2; route 2 multiplies P by 1 / l, within
          // an f32 ulp of the TPU kernel's P / l before it is rounded
          l[i] = kDivideAfter ? 0.f : __frcp_rn(l[i] > 0.f ? l[i] : 1.f);
        }
      }
    } else {  // sweep 2: P = exp(s - m), rounded where the TPU kernel does, into P V
      const int kt = kGroups * (it - n1) + grp;
      if (kt < n) {
        if (resident)  // K tile kt stayed where sweep 1 staged it
          run(resident_k(kt), Vring + ((it - n1) & 1) * kGroups * kUnit + grp * kUnit, kt, true);
        else
          run(stage + 2 * grp * kUnit, stage + (2 * grp + 1) * kUnit, kt, true);
      }
    }
    __syncthreads();  // every warp is done with this stage before its refill
  }
  if (kDivideAfter) {
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = mma::quad_sum(l[i]);
  }
  if (kGroups > 1) {  // group 0 adds the other groups' P V sums, in order
    float* part = reinterpret_cast<float*>(smem_raw);  // the stages are free
    const int slot = ((grp - 1) * kWarps + qw) * 32 + lane;
    if (grp > 0) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[(j * 4 + e) * (kGroups - 1) * kWarps * 32 + slot] = acc[j][e];
      if (kDivideAfter && t == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) stats[2 * (grp * kOwn + 16 * qw + gr + 8 * i)] = l[i];
      }
    }
    __syncthreads();
    if (grp > 0) return;
    for (int g = 1; g < kGroups; ++g) {
      const int other = ((g - 1) * kWarps + qw) * 32 + lane;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[j][e] += part[(j * 4 + e) * (kGroups - 1) * kWarps * 32 + other];
      if (kDivideAfter) {
#pragma unroll
        for (int i = 0; i < 2; ++i) l[i] += stats[2 * (g * kOwn + 16 * qw + gr + 8 * i)];
      }
    }
  }
  if (kDivideAfter) {  // out = (bf16(P) V) / l, as (bf16(P) V) * (1 / l)
    const float inv[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = __fmul_rn(acc[j][e], inv[e >> 1]);
  }
  mma::store_rows<D>(acc, out + frame(s, ld_out), ld_out, p0 + 16 * qw, p1);
}


}  // namespace l3d
}  // namespace wmz

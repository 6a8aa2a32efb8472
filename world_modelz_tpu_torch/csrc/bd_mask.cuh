// The block-diffusion mask of BD3-LM training (Arriola et al.,
// arXiv:2503.09573, section 3.2) as an index predicate, and the walk of
// 64-row tiles it leaves, for the GQA flash kernels (flash_fwd.cu,
// flash_bwd.cu: `bdflash_*`).
//
// The model sees [x_t ; x_0]: 2 L positions, the noisy copy at 0 .. L - 1
// and the clean one at L .. 2 L - 1, both cut into blocks of `bs`
// positions (b(i) = (i mod L) / bs). A noisy query sees its own block
// bidirectionally and the clean blocks before its own; a clean query sees
// the clean blocks up to and including its own; nothing sees a noisy block
// from outside it.
//
// Tiles of 64 positions (L % 64 == 0 and 64 % bs == 0, so no tile
// straddles the two halves or a block) fall into three kinds for a query
// tile at offset c = q0 mod L: whole (every pair allowed: the clean tiles
// before offset c), masked (the predicate per pair: the tile at the same
// offset in each half the queries see) and empty (skipped: everything
// else). A noisy query tile reads its own noisy tile, the clean tile at
// its offset and the c / 64 whole clean tiles before it; a clean query
// tile its own tile and the c / 64 before it. The masked tiles come first,
// so every row meets an allowed key in its first tile. A key tile is read
// by the transposed walk: a noisy key tile by its own query tile only, a
// clean key tile at offset c by the noisy and the clean query tile at c
// (masked) and by both halves' tiles after c (whole).
#pragma once

namespace wmz {
namespace bd {

constexpr int kTile = 64;

// whether query position i may see key position j
__device__ __forceinline__ bool allowed(int i, int j, int L, int bs) {
  const bool qn = i < L, kn = j < L;
  const int bi = (qn ? i : i - L) / bs, bj = (kn ? j : j - L) / bs;
  return qn ? (kn ? bi == bj : bj < bi) : (!kn && bj <= bi);
}

// the key tiles of query tile q0: how many, the first key of step s, and
// whether step s evaluates the predicate
__device__ __forceinline__ int q_steps(int q0, int L) {
  return q0 < L ? q0 / kTile + 2 : (q0 - L) / kTile + 1;
}
__device__ __forceinline__ int q_step_key(int q0, int L, int s) {
  if (s == 0) return q0;
  if (q0 < L) return s == 1 ? L + q0 : L + (s - 2) * kTile;
  return L + (s - 1) * kTile;
}
__device__ __forceinline__ bool q_step_masked(int q0, int L, int s) {
  return s < (q0 < L ? 2 : 1);
}

// the query tiles that read key tile k0: how many, the first query of
// step s, and whether step s evaluates the predicate
__device__ __forceinline__ int k_steps(int k0, int L) {
  return k0 < L ? 1 : 2 * ((2 * L - k0) / kTile);
}
__device__ __forceinline__ int k_step_query(int k0, int L, int s) {
  if (k0 < L) return k0;
  const int c = k0 - L;
  if (s < 2) return s == 0 ? c : k0;
  const int i = s - 2, tile = c + kTile * (1 + i / 2);
  return (i & 1) ? L + tile : tile;
}
__device__ __forceinline__ bool k_step_masked(int k0, int L, int s) {
  return s < (k0 < L ? 1 : 2);
}

}  // namespace bd
}  // namespace wmz

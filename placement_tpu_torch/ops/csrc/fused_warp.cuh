// What the one-warp-per-board kernels share: a board's grid and legality
// planes as 32-bit masks over the warp's lanes, and the loops over rows as
// warp operations. Used by the pin kernels (fused_rollout_warp.cu) and the
// reduced kernels (fused_rollout.cu); each helper exists once, here, for
// the two layouts a kernel picks at compile time (FLAT):
//
//   * rows (FLAT = false, the default instantiations: sides <= 32): lane x
//     holds row x of the grid and of the two legality planes;
//   * flat (FLAT = true, the general instantiations: any board of up to
//     1024 cells, so a side may pass 32): the board is its row-major bit
//     string, lane i holding cells 32i .. 32i + 31 (bit b = cell 32i + b).
//     A shift of the string by s cells is two shuffles and a 64-bit shift
//     (flat_down, flat_up), so a footprint's rows are shifts by multiples
//     of W; the order of the k-th legal cell and the action indices are
//     the rows layout's.
//
// In the rows layout (bit y of lane x = cell x*W + y)
//   * a plane's count of legal anchors is a popcount and a warp sum;
//   * the k-th legal cell is a prefix scan of the row counts, a ballot for
//     the row and a ballot for the column;
//   * the anchors of a (ph, pw) footprint are log2(ph) shuffles down (the
//     rows the footprint covers), log2(pw) shifts (its columns) and a mask;
//   * painting a footprint is one masked OR on the lanes of its rows;
//   * the f32 leaves are read and written as runs of 32 contiguous cells,
//     whatever the row width: a ballot turns a run into 32 bits of the
//     board's bit string, and each lane cuts its row's bits out of it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;

static_assert(MAX_H <= 32, "a grid row per lane (rows layout)");

__device__ __forceinline__ int warp_sum(int v) {
  return (int)__reduce_add_sync(FULL, (unsigned)v);
}

// Inclusive prefix sum over lanes 0..n-1 (right there; other lanes' result
// is not used).
__device__ __forceinline__ int warp_scan(int v, int lane, int n) {
  for (int d = 1; d < n; d <<= 1) {
    const int u = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// ---- legality planes ------------------------------------------------------

// The footprints a kernel has planes for (_build_kernel's `combos`):
// SQUARE's one n x n, otherwise the component ranges and their transposes.
template <bool SQUARE>
__device__ __forceinline__ bool in_footprints(const FusedRolloutParams& p,
                                              int h, int w) {
  if (SQUARE) return h == p.component_n && w == p.component_n;
  return (h >= p.min_h && h <= p.max_h && w >= p.min_w && w <= p.max_w) ||
         (w >= p.min_h && w <= p.max_h && h >= p.min_w && h <= p.max_w);
}

// ---- the flat layout's shifts ---------------------------------------------

// Word `lane` of the board's bit string moved s cells towards cell 0 (bit a
// of the result = cell a + s); 0 past the last word.
__device__ __forceinline__ uint32_t flat_down(uint32_t v, int s, int lane) {
  const int src = lane + (s >> 5), r = s & 31;
  const uint32_t lo = __shfl_sync(FULL, v, src & 31);
  const uint32_t hi = __shfl_sync(FULL, v, (src + 1) & 31);
  const uint64_t w = (src < 32 ? (uint64_t)lo : 0ull) |
                     (src + 1 < 32 ? (uint64_t)hi << 32 : 0ull);
  return (uint32_t)(w >> r);
}

// Word `lane` of the board's bit string moved s cells away from cell 0 (bit
// a of the result = cell a - s); 0 before the first word.
__device__ __forceinline__ uint32_t flat_up(uint32_t v, int s, int lane) {
  const int src = lane - (s >> 5), r = s & 31;
  const uint32_t hi = __shfl_sync(FULL, v, src & 31);
  const uint32_t lo = __shfl_sync(FULL, v, (src - 1) & 31);
  const uint64_t w = (src >= 0 ? (uint64_t)hi << 32 : 0ull) |
                     (src >= 1 ? (uint64_t)lo : 0ull);
  return (uint32_t)((w << r) >> 32);
}

// Word `lane` of the run of cells a0 .. a0 + len - 1.
__device__ __forceinline__ uint32_t flat_run(int a0, int len, int lane) {
  const int lo = max(a0 - 32 * lane, 0), hi = min(a0 + len - 32 * lane, 32);
  if (hi <= lo) return 0u;
  return (hi - lo >= 32 ? FULL : (1u << (hi - lo)) - 1u) << lo;
}

// The OR of `v` moved by 0, d, 2d, .. (n - 1) d cells (up or down): n
// copies in ceil(log2 n) doubling steps.
template <bool UP>
__device__ __forceinline__ uint32_t flat_spread(uint32_t v, int n, int d,
                                                int lane) {
  for (int k = 1; k < n;) {
    const int step = min(k, n - k);
    v |= UP ? flat_up(v, step * d, lane) : flat_down(v, step * d, lane);
    k += step;
  }
  return v;
}

// Row `lane` (FLAT: word `lane`) of the anchors where an (ph, pw) footprint
// is in bounds and covers no occupied cell; 0 for a footprint outside the
// config's set.
template <bool SQUARE, bool FLAT>
__device__ uint32_t free_row(const FusedRolloutParams& p, uint32_t grid,
                             int ph, int pw, int lane) {
  const int H = p.height, W = p.width;
  const bool known = in_footprints<SQUARE>(p, ph, pw) && pw <= W;
  if (!known) return 0u;
  if constexpr (FLAT) {
    // the cells an anchor's footprint covers: its row's next pw - 1 cells
    // (an anchor within pw of its row's end is not in bounds, so the
    // spill into the next row is masked), and the ph - 1 rows below
    if (ph > H) return 0u;
    uint32_t occ = ph > 0 && pw > 0 ? grid : 0u;
    occ = flat_spread<false>(occ, pw, 1, lane);
    occ = flat_spread<false>(occ, ph, W, lane);
    const uint32_t anchors =
        flat_spread<true>(flat_run(0, W - pw + 1, lane), H - ph + 1, W, lane);
    return ~occ & anchors;
  }
  const int nanchor = W - pw + 1;
  const uint32_t anchors =
      nanchor >= 32 ? FULL : ((1u << max(nanchor, 0)) - 1u);
  // occ: the OR of rows lane .. lane + ph - 1; dil: of occ's columns
  // y .. y + pw - 1 at bit y. Both windows grow by doubling: a window of n
  // takes ceil(log2 n) steps. (A lane whose window leaves the warp reads
  // itself; it has lane + ph > H and is masked below.)
  uint32_t occ = ph > 0 ? grid : 0u, dil;  // an empty window covers nothing
  int n = 1;
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    if (n >= ph) break;
    const int d = min(n, ph - n);
    occ |= __shfl_down_sync(FULL, occ, d);
    n += d;
  }
  dil = pw > 0 ? occ : 0u;
  n = 1;
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    if (n >= pw) break;
    const int d = min(n, pw - n);
    dil |= dil >> d;
    n += d;
  }
  return (lane < H && lane + ph <= H) ? (~dil & anchors) : 0u;
}

__device__ __forceinline__ int plane_count(uint32_t pl) {
  return warp_sum(__popc(pl));
}

// Row xx and column yy of the k-th (0-based) legal cell in row-major order,
// the last cell if there is none: the row (FLAT: the word) is the first
// lane whose running count passes k, the column (the cell) the remaining
// rank's set bit of that row.
template <bool FLAT>
__device__ void nth_cell(const FusedRolloutParams& p, uint32_t pl, int k,
                         int lane, int& xx, int& yy) {
  const int incl = warp_scan(__popc(pl), lane, 32);
  const uint32_t past = __ballot_sync(FULL, incl > k);
  xx = p.height - 1;
  yy = p.width - 1;
  if (past == 0u) return;
  xx = __ffs(past) - 1;
  const uint32_t m = __shfl_sync(FULL, pl, xx);
  const int kk = k - (__shfl_sync(FULL, incl, xx) - __popc(m));
  const uint32_t below = (1u << lane) - 1u;
  const uint32_t hit =
      __ballot_sync(FULL, ((m >> lane) & 1u) && __popc(m & below) == kk);
  yy = __ffs(hit) - 1;
  if constexpr (FLAT) {
    const int a = 32 * xx + yy;
    xx = a / p.width;
    yy = a - xx * p.width;
  }
}

// The columns yy .. yy + pw - 1 of a row of width W, as its mask.
__device__ __forceinline__ uint32_t footprint_cols(int W, int pw, int yy) {
  const uint32_t wmask = W >= 32 ? FULL : (1u << W) - 1u;
  const uint32_t run = pw >= 32 ? FULL : (1u << max(pw, 0)) - 1u;
  return (run << yy) & wmask;
}

// Marks the (ph, pw) footprint anchored at row xx, column yy as occupied.
template <bool FLAT>
__device__ __forceinline__ void paint(const FusedRolloutParams& p,
                                      uint32_t& grid, int xx, int yy, int ph,
                                      int pw, int lane) {
  if constexpr (FLAT) {
    const int W = p.width;
    grid |= flat_spread<true>(flat_run(xx * W + yy, min(pw, W - yy), lane),
                              min(ph, p.height - xx), W, lane);
    return;
  }
  if (lane >= xx && lane < min(xx + ph, p.height))
    grid |= footprint_cols(p.width, pw, yy);
}

// ---- the f32 leaves as row masks ------------------------------------------

// Row `lane` of a board's [H*W] f32 leaf at `cells`: bit y set where cell
// lane*W + y is not 0 (FLAT: word `lane`, the cells 32 lane ..). The warp
// reads 32 contiguous cells a round.
template <bool FLAT>
__device__ uint32_t load_rows(const FusedRolloutParams& p,
                              const float* cells, int lane) {
  const int H = p.height, W = p.width, A = H * W;
  if constexpr (FLAT) {
    uint32_t word = 0u;
    for (int a0 = 0; a0 < A; a0 += 32) {
      const int a = a0 + lane;
      const uint32_t bits = __ballot_sync(FULL, a < A && cells[a] != 0.0f);
      if (lane == a0 >> 5) word = bits;
    }
    return word;
  }
  const int first = lane * W, last = first + W;   // this row's cells
  uint32_t row = 0u;
  for (int a0 = 0; a0 < A; a0 += 32) {
    const int a = a0 + lane;
    const uint32_t bits = __ballot_sync(FULL, a < A && cells[a] != 0.0f);
    const int lo = max(first, a0), hi = min(last, a0 + 32);
    if (lane < H && lo < hi) {
      const uint32_t part = hi - lo >= 32 ? FULL : ((1u << (hi - lo)) - 1u);
      row |= ((bits >> (lo - a0)) & part) << (lo - first);
    }
  }
  return row;
}

// Writes a board's [H*W] f32 leaf at `cells` from its row masks (FLAT:
// words), 32 contiguous cells a round.
template <bool FLAT>
__device__ void store_rows(const FusedRolloutParams& p, float* cells,
                           uint32_t row, int lane) {
  const int W = p.width, A = p.height * W;
  for (int a0 = 0; a0 < A; a0 += 32) {
    const int a = a0 + lane;
    if constexpr (FLAT) {
      const uint32_t m = __shfl_sync(FULL, row, a0 >> 5);
      if (a < A) cells[a] = (float)((m >> lane) & 1u);
      continue;
    }
    const int x = a / W, y = a - x * W;
    const uint32_t m = __shfl_sync(FULL, row, x);
    if (a < A) cells[a] = (float)((m >> y) & 1u);
  }
}

}  // namespace

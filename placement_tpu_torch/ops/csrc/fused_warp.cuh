// What the one-warp-per-board kernels share: a board's grid and legality
// planes as 32-bit masks over the warp's lanes, and the loops over rows as
// warp operations. Used by the pin kernels (fused_rollout_warp.cu) and the
// reduced kernels (fused_rollout.cu); each helper exists once, here, for
// the two layouts a kernel picks at compile time (FLAT):
//
//   * rows (FLAT = false, the default instantiations: sides <= 32): lane x
//     holds row x of the grid and of the two legality planes;
//   * flat (FLAT = true, the general instantiations: any board of up to
//     1024 cells, so a side may pass 32): the board is a bit string over
//     the lanes, lane i holding bits 32i .. 32i + 31, and cell (x, y) is
//     bit x S + y, S the row stride (FusedRolloutParams::row_stride): 32
//     where both sides fit a lane (a row a lane, as in the rows layout), 32
//     ceil(W / 32) for a row over 32 cells (a row a run of whole words),
//     W for a column over 32 cells (rows end to end). The bits past a
//     row's W cells are 0. The order of the k-th legal cell and the action
//     indices are the rows layout's. A row below is a shift by S bits: for
//     S a multiple of 32 one shuffle of whole words, else a funnel of two
//     (flat_down); a footprint's columns are the next word's funnel and
//     shifts in a 64-bit register; the anchor mask and a painted footprint
//     are formed on each lane without a shuffle, and a bit's row and
//     column come from a multiply by the stride's reciprocal (flat_rowcol).
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

// ---- the flat layout ------------------------------------------------------

// Bit t's row and column, t < 2^10: t / S is (t * stride_recip) >> 22
// exactly (stride_recip = ceil(2^22 / S), whose error times t stays under
// 2^22 for S <= 2^12).
static_assert(MAX_H * MAX_W <= 1024, "flat_rowcol's exact range");
__device__ __forceinline__ void flat_rowcol(const FusedRolloutParams& p,
                                            int t, int& xx, int& yy) {
  xx = (int)(((uint32_t)t * (uint32_t)p.stride_recip) >> 22);
  yy = t - xx * p.row_stride;
}

// Word `lane` of the board's bit string moved s bits towards bit 0 (bit t
// of the result = bit t + s); 0 past the last word. Words lane + s / 32 and
// the one after: the first is the lane's own for s < 32, and a shift by a
// multiple of 32 needs no second.
__device__ __forceinline__ uint32_t flat_down(uint32_t v, int s, int lane) {
  const int q = s >> 5, r = s & 31, src = lane + q;
  const uint32_t lo0 = q == 0 ? v : __shfl_sync(FULL, v, src & 31);
  const uint32_t lo = src < 32 ? lo0 : 0u;
  if (r == 0) return lo;
  const uint32_t hi0 = __shfl_sync(FULL, v, (src + 1) & 31);
  const uint32_t hi = src + 1 < 32 ? hi0 : 0u;
  return (uint32_t)((((uint64_t)hi << 32) | lo) >> r);
}

// Word `lane` of the run of bits t0 .. t0 + len - 1.
__device__ __forceinline__ uint32_t flat_run(int t0, int len, int lane) {
  const int lo = max(t0 - 32 * lane, 0), hi = min(t0 + len - 32 * lane, 32);
  if (hi <= lo) return 0u;
  return (hi - lo >= 32 ? FULL : (1u << (hi - lo)) - 1u) << lo;
}

// The longest side of a footprint the config places.
__device__ __forceinline__ int max_side(const FusedRolloutParams& p) {
  return max(max(p.max_h, p.max_w), p.component_n);
}

// Word `lane` of the cells that a (ph, pw) footprint anchored at each cell
// covers, OR'd: the cell's next pw - 1 cells in its row (past the row's
// end they are padding, or the next row's start, which the anchor mask
// excludes), then the ph - 1 rows below, each a shift by S.
__device__ __forceinline__ uint32_t flat_cover(const FusedRolloutParams& p,
                                               uint32_t grid, int ph, int pw,
                                               int lane) {
  const int S = p.row_stride;
  // columns: within the lane's word where it holds the whole row (an
  // anchor's columns end inside the row), else with the next word in a
  // 64-bit register (a footprint's width under 34), else by shifts of the
  // string
  uint32_t cols = grid;
  if (S == 32) {
    for (int k = 1; k < pw;) {
      const int step = min(k, pw - k);
      cols |= cols >> step;
      k += step;
    }
  } else if (max_side(p) <= 33) {
    const uint32_t next = __shfl_down_sync(FULL, grid, 1);
    uint64_t x = (uint64_t)(lane < 31 ? next : 0u) << 32 | grid;
    for (int k = 1; k < pw;) {
      const int step = min(k, pw - k);
      x |= x >> step;
      k += step;
    }
    cols = (uint32_t)x;
  } else {
    for (int k = 1; k < pw;) {
      const int step = min(k, pw - k);
      cols |= flat_down(cols, step, lane);
      k += step;
    }
  }
  // rows: a window of rows grows by doubling, ceil(log2 ph) shifts by a
  // multiple of S (one shuffle each where S is whole words; a lane whose
  // window leaves the warp reads itself, which adds nothing)
  uint32_t occ = cols;
  if (S % 32 == 0) {
    const int R = S >> 5;
    int n = 1;
#pragma unroll
    for (int s = 0; s < 5; ++s) {
      if (n >= ph) break;
      const int d = min(n, ph - n);
      occ |= __shfl_down_sync(FULL, occ, d * R);
      n += d;
    }
  } else {
    for (int k = 1; k < ph;) {
      const int step = min(k, ph - k);
      occ |= flat_down(occ, step * S, lane);
      k += step;
    }
  }
  return occ;
}

// Word `lane` of the anchors of an in-bounds (ph, pw) footprint (ph <= H,
// pw <= W): the cells of rows 0 .. H - ph whose column is at most W - pw.
// Where S is whole words the lane's word lies in one row, from column c0;
// else (S = W <= 32) its columns are bits c0 .. c0 + 31 of a pattern of
// period W built by doubling in a 64-bit register.
__device__ __forceinline__ uint32_t flat_anchors(const FusedRolloutParams& p,
                                                 int ph, int pw, int lane) {
  const int H = p.height, W = p.width, S = p.row_stride;
  const int K = max(W - pw + 1, 0);  // anchors a row
  int row0, c0;
  flat_rowcol(p, 32 * lane, row0, c0);
  if (S % 32 == 0) {
    const int n = K - c0;  // anchors in this word
    const uint32_t cols = n >= 32 ? FULL : n > 0 ? (1u << n) - 1u : 0u;
    return row0 <= H - ph ? cols : 0u;
  }
  uint64_t rep = (1ull << K) - 1ull;
  for (int span = W; span < 64; span <<= 1) rep |= rep << span;
  return (uint32_t)(rep >> c0) & flat_run(0, (H - ph + 1) * W, lane);
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
    if (ph > H) return 0u;
    const uint32_t occ = ph > 0 && pw > 0 ? flat_cover(p, grid, ph, pw, lane)
                                          : 0u;
    return ~occ & flat_anchors(p, ph, pw, lane);
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
// rank's set bit of that row. FLAT: the scan runs over the board's words
// alone (a later lane's partial sum never passes k where no word's running
// count does), every lane takes part whether or not a cell is found, and
// the cell index becomes (xx, yy) by flat_rowcol.
template <bool FLAT>
__device__ void nth_cell(const FusedRolloutParams& p, uint32_t pl, int k,
                         int lane, int& xx, int& yy) {
  if constexpr (FLAT) {
    const uint32_t below = (1u << lane) - 1u;
    const int words = (p.height * p.row_stride + 31) >> 5;
    const int incl = warp_scan(__popc(pl), lane, words);
    const uint32_t past = __ballot_sync(FULL, incl > k);
    const int w = past ? __ffs(past) - 1 : 0;
    const uint32_t m = __shfl_sync(FULL, pl, w);
    const int kk = k - (__shfl_sync(FULL, incl, w) - __popc(m));
    const uint32_t hit =
        __ballot_sync(FULL, ((m >> lane) & 1u) && __popc(m & below) == kk);
    flat_rowcol(p, 32 * w + __ffs(hit) - 1, xx, yy);
    if (past == 0u) {
      xx = p.height - 1;
      yy = p.width - 1;
    }
    return;
  }
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
    // the footprint's rows as runs of bits, on the lanes they fall on:
    // where S is whole words, each lane's word is in one row, from column
    // c0, and takes its part of the run if the row is the footprint's
    const int S = p.row_stride, run = min(pw, p.width - yy);
    const int rows = min(ph, p.height - xx);
    if (S % 32 == 0) {
      int x, c0;
      flat_rowcol(p, 32 * lane, x, c0);
      if (x >= xx && x < xx + rows) grid |= flat_run(yy - c0, run, 0);
      return;
    }
    uint32_t m = 0u;
    for (int i = 0; i < rows; ++i) m |= flat_run((xx + i) * S + yy, run, lane);
    grid |= m;
    return;
  }
  if (lane >= xx && lane < min(xx + ph, p.height))
    grid |= footprint_cols(p.width, pw, yy);
}

// ---- the f32 leaves as row masks ------------------------------------------

// Row `lane` of a board's [H*W] f32 leaf at `cells`: bit y set where cell
// lane*W + y is not 0 (FLAT: word `lane`, whose bits are the leaf's cells
// first .. last - 1, contiguous in both layouts). The warp reads 32
// contiguous cells a round.
template <bool FLAT>
__device__ uint32_t load_rows(const FusedRolloutParams& p,
                              const float* cells, int lane) {
  const int H = p.height, W = p.width, A = H * W;
  if constexpr (FLAT) {
    int x, y0;
    flat_rowcol(p, 32 * lane, x, y0);
    const bool packed = p.row_stride == W;  // rows end to end
    const int first = packed ? 32 * lane : x * W + y0;
    const int last = packed ? min(first + 32, A)
                     : x < H ? x * W + min(y0 + 32, W) : first;
    uint32_t word = 0u;
    for (int a0 = 0; a0 < A; a0 += 32) {
      const int a = a0 + lane;
      const uint32_t bits = __ballot_sync(FULL, a < A && cells[a] != 0.0f);
      const int lo = max(first, a0), hi = min(last, a0 + 32);
      if (lo < hi) {
        const uint32_t part = hi - lo >= 32 ? FULL : ((1u << (hi - lo)) - 1u);
        word |= ((bits >> (lo - a0)) & part) << (lo - first);
      }
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
    const int x = a / W, y = a - x * W;
    if constexpr (FLAT) {
      const int t = x * p.row_stride + y;  // the cell's bit
      const uint32_t m = __shfl_sync(FULL, row, (t >> 5) & 31);
      if (a < A) cells[a] = (float)((m >> (t & 31)) & 1u);
      continue;
    }
    const uint32_t m = __shfl_sync(FULL, row, x);
    if (a < A) cells[a] = (float)((m >> y) & 1u);
  }
}

}  // namespace

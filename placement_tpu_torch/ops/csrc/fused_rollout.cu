// Fused rollout chunk of the reduced kernels, one warp per board (four for
// the general square), and the C entry points of the kernel library.
//
// Replaces the Pallas TPU kernel of placement_tpu/ops/fused_rollout.py
// (make_fused_rollout's pl.pallas_call at :866, body _build_kernel
// :290-763) for the SQUARE and RECT environments (generate :364-397, the
// step's sampling :610-643 and reward :711-713): two instantiations of
// fused_rollout_reduced_kernel<K, FLAT> each (enum Kernel in
// fused_common.cuh), a grid row per lane (sides <= 32) and, for a board
// with a side over 32, its bit string over the lanes (fused_warp.cuh), or
// for the general square over an 8-lane segment (below).
// No pin tables, +1 per placement, one (SQUARE) or two (RECT) orientation
// planes. The pin kernels (K_CENTROID, K_BEAM, K_BOTH) are
// fused_rollout_warp.cu's; fused_rollout_launch below dispatches to them.
// A warp runs the whole num_steps chunk of its boards: random legal-action
// sampling, placement, the next legality planes, the done test, and on
// episode end the regeneration of a fresh instance.
//
// What bounds it on an H100: for SQUARE the bytes (three [H*W] f32 leaves
// and two component tables a board, read and written once: ~10 MB at 4096
// flagship boards, ~3 us at 3.35 TB/s), for RECT the integer operations of
// two planes a step (chip_smoke.py's _chunk_bound counts both). In between
// lies a serial chain per board of 50 dependent steps.
//
// What the design does about it. One thread per board kept the row masks
// and component tables in a 912 B stack frame indexed by runtime values,
// so every step of the chain went through local memory, and read the f32
// leaves cell by cell, 400 B apart between neighbouring threads. Here:
//   * a board is a warp: lane x holds row x of the grid and of the two
//     legality planes (three registers), and the loops over rows are warp
//     operations (fused_warp.cuh, shared with the pin kernels);
//   * the component tables (up to 64 entries) sit on two lane slots, entry
//     c on lane c % 32 in slot c / 32; the component under the cursor is
//     one shuffle, and one more only where a config has over 32 components;
//   * each plane's count of legal anchors and the size of the component
//     under the cursor are kept from the step that made them, a square
//     component's second plane is a copy, and the sampled anchor stays a
//     (row, column) pair, so no step divides by the grid's width (the flat
//     layout's bit index becomes one by a multiply by the row stride's
//     reciprocal);
//   * RECT's generator draws entry c's height and width on entry c's lane;
//   * the leaves are read and written 32 contiguous cells at a time, and
//     the pin leaves (absent from these environments, but part of the
//     state) pass through with a lane-strided copy, or are written as -1
//     once the board has been regenerated.
// The cursor, the component count and the counts of legal anchors are
// uniform across the warp, so every branch is warp-uniform.
//
// Semantics kept bit for bit with the JAX kernel: the counter-hash PRNG
// (_mix/_Rng) with the LOGICAL block of make_fused_rollout's `block`
// argument in the salt and row, whatever the launch geometry, and the draw
// order (call 1 in the step; 2..4 in RECT's generator, none in SQUARE's).
// Build with -fmad=false and without --use_fast_math, as the pin kernels
// need.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "fused_common.cuh"
#include "fused_warp.cuh"

namespace {

constexpr int WARPS = 4;                 // boards per block
constexpr int BLOCK_THREADS = 32 * WARPS;
constexpr int SLOTS = MAX_C_NOPIN / 32;  // component entries per lane

static_assert(MAX_C_NOPIN % 32 == 0, "whole lane slots");

// A board of the reduced kernels: lane x's grid and plane rows, and the
// component entries lane + 32 * s. Its pin leaves stay in device memory:
// they pass through unchanged until the board is regenerated (`fresh`),
// which writes them as -1 with num_pins = 0.
struct ReducedBoard {
  uint32_t grid, pl0, pl1;
  int32_t ch[SLOTS], cw[SLOTS];
  int32_t cur, numc;  // uniform
  int32_t h, w;       // the component under the cursor (uniform)
  int32_t n0, n1;     // legal anchors of pl0, pl1 (uniform)
  bool fresh;         // uniform
};

// t[min(i, C-1)] of a component table, 0 for i < 0 (uniform i). Each slot
// is shuffled under its own static index: a slot picked by a runtime index
// would move the board into local memory.
__device__ __forceinline__ int comp_at(const int32_t (&t)[SLOTS], int i,
                                       int C) {
  i = min(i, C - 1);
  const int src = max(i, 0);
  int got = __shfl_sync(FULL, t[0], src & 31);
#pragma unroll
  for (int s = 1; s < SLOTS; ++s) {
    if (C <= 32 * s) break;
    const int hi = __shfl_sync(FULL, t[s], src & 31);
    if ((src >> 5) == s) got = hi;
  }
  return i >= 0 ? got : 0;
}

// Moves to the component under the cursor: its size, and unless the board
// has `placed_all`, its legality planes and their counts. A square
// component's (w, h) is the same footprint (always so for SQUARE): plane 1
// copies plane 0.
template <int K, bool FLAT>
__device__ __forceinline__ void next_component(const FusedRolloutParams& p,
                                               ReducedBoard& b,
                                               bool placed_all, int lane) {
  b.h = comp_at(b.ch, b.cur, p.components);
  b.w = comp_at(b.cw, b.cur, p.components);
  if (placed_all) {
    b.pl0 = b.pl1 = 0u;
    b.n0 = b.n1 = 0;
    return;
  }
  b.pl0 = free_row<K == K_SQUARE, FLAT>(p, b.grid, b.h, b.w, lane);
  b.n0 = plane_count(b.pl0);
  if (K == K_SQUARE || b.h == b.w) {
    b.pl1 = b.pl0;
    b.n1 = b.n0;
  } else {
    b.pl1 = free_row<false, FLAT>(p, b.grid, b.w, b.h, lane);
    b.n1 = plane_count(b.pl1);
  }
}

// ---- in-kernel instance generator (generate) -----------------------------

// SQUARE's unlimited supply of n x n components draws nothing (:364-377);
// RECT draws heights (call 2), widths (call 3) and the count (call 4), each
// entry on its own lane and slot (:379-397).
template <int K, bool FLAT>
__device__ void generate(const FusedRolloutParams& p, const Rng& rng,
                         ReducedBoard& b, int lane) {
  const int C = p.components;
  if (K == K_SQUARE) {
    b.numc = p.height * p.width;
  } else {
    b.numc = randint(p.min_c, p.max_c, rng.uniform(4, 1, 0));
  }
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int c = lane + 32 * s;
    int h = 0, w = 0;
    if (K == K_SQUARE) {
      h = w = c < C ? p.component_n : 0;
    } else if (32 * s < C) {
      h = randint(p.min_h, p.max_h, rng.uniform(2, C, c));
      w = randint(p.min_w, p.max_w, rng.uniform(3, C, c));
      if (c >= b.numc || c >= C) h = w = 0;
    }
    b.ch[s] = h;
    b.cw[s] = w;
  }
  b.grid = 0u;
  b.cur = 0;
  b.fresh = true;
  next_component<K, FLAT>(p, b, false, lane);
}

// ---- one step (body) -----------------------------------------------------

// Samples a legal action (:610-643: RECT over two planes, SQUARE over one),
// places it for +1 (:711-713), makes the next component's planes and, on
// done, regenerates the board.
template <int K, bool FLAT>
__device__ void step(const FusedRolloutParams& p, const Rng& rng,
                     ReducedBoard& b, float& rsum, int& dcnt, int lane) {
  const int c0 = b.n0, c1 = K == K_SQUARE ? 0 : b.n1;
  const float total = (float)(c0 + c1);
  const bool alive = total > 0.0f;
  if (alive) {
    const float u = rng.uniform(1, 1, 0);
    float tgt = fminf(floorf(u * total), total - 1.0f);
    tgt = fmaxf(tgt, 0.0f);
    const float pre1 = (float)c0;
    const bool odd = K == K_RECT && tgt >= pre1;  // the (w, h) orientation
    const float tin = tgt - (odd ? pre1 : 0.0f);
    int xx, yy;
    nth_cell<FLAT>(p, odd ? b.pl1 : b.pl0, (int)tin, lane, xx, yy);
    paint<FLAT>(p, b.grid, xx, yy, odd ? b.w : b.h, odd ? b.h : b.w, lane);
    ++b.cur;
    rsum = rsum + 1.0f;
  }
  const bool placed_all = b.cur >= b.numc;
  next_component<K, FLAT>(p, b, placed_all, lane);
  const bool done = placed_all || b.n0 + b.n1 == 0 || !alive;
  if (!done) return;
  ++dcnt;
  generate<K, FLAT>(p, rng, b, lane);
}

// ---- the general SQUARE kernel: four boards a warp ------------------------
//
// A general square board (a side over 32, area <= 144) is at most 8 words
// of the flat layout: a column over 32 cells has W <= 4 and S = W, so
// ceil(H W / 32) <= 5 words; a row over 32 cells has H <= 4 and S = 32
// ceil(W / 32), so H S / 32 <= 8 (4 x 36 -> 8, 3 x 48 -> 6, 1 x 144 -> 5).
// So a board sits on an aligned segment of SEG = 8 lanes, word sl = lane & 7
// on lane sl of its segment, and a warp runs four boards. Every warp
// operation of a step serves the four at once: shuffles take width SEG,
// ballots are cut to the segment's byte, sums are scans over the segment.
// The step has no branch that differs between the segments: alive, done
// and the regeneration are selects.
//
// SQUARE's footprint is always n x n (component_n) and its grid only gains
// cells, so the legality plane is not rebuilt from the grid each step (a
// cover of log2 n funnels a direction and the anchor mask): painting the
// n x n square at (xx, yy) removes exactly the anchors whose window meets
// it, rows xx - n + 1 .. xx + n - 1 and columns yy - n + 1 .. yy + n - 1,
// so plane' = plane & ~kill(xx, yy). On done the board takes the anchor
// mask, a constant of the chunk. The first step after the load still
// rebuilds the plane from the grid, as JAX's kernel does (it samples from
// the loaded plane0 and then recomputes from the grid, whatever plane0
// held, and paints the component under the loaded cursor, whatever its
// size); from then on the plane equals free(grid) by induction. The count
// of legal anchors is the segment's scan, which the sampling needs anyway;
// whether the plane is empty is one ballot.
//
// A footprint and a kill mask are constant patterns moved to the sampled
// bit, a funnel shift a lane (SegWord): with rows end to end (S = W <= 4)
// the n x n square and the (2n - 1)-square, rows W apart, fit 32 bits and
// move by the bit index alone (a kill bit left of column 0 lands on a
// column past W - n of the row above, never an anchor; none passes column
// W - 1, as the anchor's square ends there); where S is whole words a word
// lies in one row, which takes the run of n (2n - 1) columns or nothing.
// The kernel is bound by the latency of a step's chain (4 boards a warp
// leave 2 warps a scheduler at 4096 boards), so each step's uniform is
// drawn ahead: lane sl draws step t0 + sl's every SEG steps, and a step
// takes its own with one shuffle.

constexpr int SEG = 8;                     // lanes (words) a board
constexpr int SEG_BOARDS = 32 / SEG;       // boards a warp
constexpr uint32_t SEG_BITS = (1u << SEG) - 1u;
constexpr int SEG_ROUNDS = SEG;            // 32-cell rounds of a board's leaf

// Inclusive prefix sum over the segment's lanes 0 .. words - 1 (the
// board's words; the later lanes' sums are not used).
__device__ __forceinline__ int seg_scan(int v, int sl, int words) {
#pragma unroll
  for (int d = 1; d < SEG; d <<= 1) {
    if (d >= words) break;
    const int u = __shfl_up_sync(FULL, v, d, SEG);
    if (sl >= d) v += u;
  }
  return v;
}

// The segment's bits of a warp ballot (bit i: lane i of the segment).
__device__ __forceinline__ uint32_t seg_ballot(bool pred, int lane) {
  return (__ballot_sync(FULL, pred) >> (lane & ~(SEG - 1))) & SEG_BITS;
}

// Word sl of the board's bit string moved s bits towards bit 0 (bit t of
// the result = bit t + s), 0 past the segment: flat_down on a segment.
__device__ __forceinline__ uint32_t seg_down(uint32_t v, int s, int sl) {
  const int q = s >> 5, r = s & 31, src = sl + q;
  const uint32_t lo0 = __shfl_sync(FULL, v, src & (SEG - 1), SEG);
  const uint32_t hi0 = __shfl_sync(FULL, v, (src + 1) & (SEG - 1), SEG);
  const uint32_t lo = src < SEG ? lo0 : 0u;
  const uint32_t hi = src + 1 < SEG ? hi0 : 0u;
  return r == 0 ? lo : (uint32_t)((((uint64_t)hi << 32) | lo) >> r);
}

// The pattern `pat` (bit 31 clear) with its bit 0 moved to bit d of a
// word: pat << d, or pat >> -d for d < 0; nothing of it for |d| >= 32.
__device__ __forceinline__ uint32_t moved(uint32_t pat, int d) {
  d = min(max(d, -31), 32);
  return (uint32_t)(((uint64_t)pat << 32) >> (32 - d));
}

// The position of the k-th (0-based) set bit of m, for 0 <= k < popc(m):
// halves of the remaining window by their popcounts.
__device__ __forceinline__ int nth_set_bit(uint32_t m, int k) {
  int pos = 0;
#pragma unroll
  for (int half = 16; half > 0; half >>= 1) {
    const int c = __popc((m >> pos) & ((1u << half) - 1u));
    if (k >= c) {
      k -= c;
      pos += half;
    }
  }
  return pos;
}

// Word sl of a board's [H*W] f32 leaf at `cells` (nullptr: an empty
// board), as load_rows<true> cuts it; the segment reads 32 contiguous cells
// a round, lane sl the cells SEG j + sl, and the segment's bytes of the
// round's 32 / SEG ballots are its 32 bits. The rounds are unrolled to the
// most a board holds, so every load is issued before the first ballot.
__device__ uint32_t seg_load(const FusedRolloutParams& p, const float* cells,
                             int sl, int lane) {
  const int H = p.height, W = p.width, A = H * W;
  int x, y0;
  flat_rowcol(p, 32 * sl, x, y0);
  const bool packed = p.row_stride == W;  // rows end to end
  const int first = packed ? 32 * sl : x * W + y0;
  const int last = packed ? min(first + 32, A)
                   : x < H ? x * W + min(y0 + 32, W) : first;
  uint32_t word = 0u;
#pragma unroll
  for (int r = 0; r < SEG_ROUNDS; ++r) {
    const int a0 = 32 * r;
    uint32_t bits = 0u;
#pragma unroll
    for (int j = 0; j < 32 / SEG; ++j) {
      const int a = a0 + SEG * j + sl;
      const bool set = cells != nullptr && a < A && cells[a] != 0.0f;
      bits |= seg_ballot(set, lane) << (SEG * j);
    }
    const int lo = max(first, a0), hi = min(last, a0 + 32);
    if (lo < hi) {
      const uint32_t part = hi - lo >= 32 ? FULL : ((1u << (hi - lo)) - 1u);
      word |= ((bits >> (lo - a0)) & part) << (lo - first);
    }
  }
  return word;
}

// Writes a board's [H*W] f32 leaf at `cells` (nullptr: nothing) from word
// sl of its bit string, 32 contiguous cells a round; a cell's row is a
// multiply by W's reciprocal (exact for a < 2^10, as flat_rowcol's).
__device__ void seg_store(const FusedRolloutParams& p, float* cells,
                          uint32_t word, int sl) {
  const int W = p.width, A = p.height * W;
  const uint32_t recip = ((1u << 22) + W - 1) / W;
  for (int a0 = 0; a0 < A; a0 += 32) {
#pragma unroll
    for (int j = 0; j < 32 / SEG; ++j) {
      const int a = a0 + SEG * j + sl;
      const int x = (int)(((uint32_t)a * recip) >> 22);
      const int t = x * p.row_stride + a - x * W;  // the cell's bit
      const uint32_t m = __shfl_sync(FULL, word, (t >> 5) & (SEG - 1), SEG);
      if (cells != nullptr && a < A) cells[a] = (float)((m >> (t & 31)) & 1u);
    }
  }
}

// Word sl's place on the board and the chunk's patterns. Where S is whole
// words (a row over 32 cells, or sides <= 32) the word is in row `row`
// from column `col`, and the patterns are runs of n and 2n - 1 columns;
// else (rows end to end) the n x n square and the (2n - 1)-square, rows W
// apart, from their first cell.
struct SegWord {
  int row, col;
  uint32_t foot, kill;
};

template <bool WHOLE>
__device__ __forceinline__ SegWord seg_word(const FusedRolloutParams& p,
                                            int sl) {
  SegWord g;
  const int W = p.width, n = max(p.component_n, 1);
  flat_rowcol(p, 32 * sl, g.row, g.col);
  const uint32_t run = (1u << min(n, 31)) - 1u;
  const uint32_t run2 = (1u << min(2 * n - 1, 31)) - 1u;
  g.foot = run;
  g.kill = run2;
  if (!WHOLE) {
    uint64_t foot = 0ull, kill = 0ull;  // n <= W <= 4: up to 31 bits
    for (int i = 0; i < 2 * n - 1 && i * W < 64; ++i) {
      if (i < n) foot |= (uint64_t)run << (i * W);
      kill |= (uint64_t)run2 << (i * W);
    }
    g.foot = (uint32_t)foot & 0x7fffffffu;
    g.kill = (uint32_t)kill & 0x7fffffffu;
  }
  return g;
}

// Word sl of the cells of rows x0 .. x0 + rows - 1 and columns c0 .. c0 +
// cols - 1 (0 <= c0, c0 + cols <= W, x0 + rows <= H; an empty rectangle
// for rows or cols <= 0): the loaded component the first step paints.
template <bool WHOLE>
__device__ __forceinline__ uint32_t seg_rect(const FusedRolloutParams& p,
                                             const SegWord& g, int sl,
                                             int x0, int rows, int c0,
                                             int cols) {
  rows = max(rows, 0);
  cols = max(cols, 0);
  if (WHOLE)
    return (unsigned)(g.row - x0) < (unsigned)rows
               ? flat_run(c0 - g.col, cols, 0)
               : 0u;
  const int W = p.width;
  uint64_t rep = 0ull;
  for (int j = 0; j < 64; j += W) rep |= 1ull << j;
  const uint64_t pat = (uint64_t)(((1u << cols) - 1u) << c0) * rep;
  return (uint32_t)(pat >> (32 * sl - g.row * W)) &
         flat_run(x0 * W, rows * W, sl);
}

// A board of the general square kernel, on its segment: word sl of the
// grid and of the plane; the rest is the same on the segment's lanes.
struct SquareBoard {
  uint32_t grid, pl;
  int32_t cur, numc;
  int32_t bad;   // the first component entry that is not n x n (C if none)
  float rsum;
  int32_t dcnt;
  bool fresh;    // regenerated in this chunk
};

// One step of the general square kernel (:610-643, :711-713, generate
// :364-377) with the step's uniform u. FIRST: the step after the load,
// which paints the loaded component under the cursor (h0, w0) and rebuilds
// the plane from the grid; later steps paint n x n and take the kill mask
// off the plane.
template <bool FIRST, bool WHOLE>
__device__ __forceinline__ void square_step(const FusedRolloutParams& p,
                                            float u, const SegWord& g,
                                            uint32_t anchors, int sl,
                                            int lane, int words, int h0,
                                            int w0, SquareBoard& b) {
  const int H = p.height, W = p.width, n = p.component_n;
  // sample the k-th legal anchor: the lane whose word holds it finds its
  // bit while the ballot finds the lane
  const int pc = __popc(b.pl);
  const int incl = seg_scan(pc, sl, words);
  const int count = __shfl_sync(FULL, incl, words - 1, SEG);
  const bool alive = count > 0;
  // floorf(u * total), clamped to [0, total - 1] as the JAX kernel does in
  // f32: the same values in integers
  const int k = max(min(__float2int_rd(u * (float)count), count - 1), 0);
  const int cell = 32 * sl + nth_set_bit(b.pl, k - (incl - pc));
  const uint32_t past = seg_ballot(incl > k, lane);
  const int t = __shfl_sync(FULL, cell, (__ffs(past) - 1) & (SEG - 1), SEG);
  int xx = 0, yy = 0;
  if (FIRST || WHOLE) flat_rowcol(p, t, xx, yy);
  // place it for +1
  uint32_t foot;
  if (FIRST)
    foot = seg_rect<WHOLE>(p, g, sl, xx, min(h0, H - xx), yy,
                           min(w0, W - yy));
  else if (WHOLE)
    foot = (unsigned)(g.row - xx) < (unsigned)n ? moved(g.foot, yy - g.col)
                                                 : 0u;
  else
    foot = moved(g.foot, t - 32 * sl);
  b.grid |= alive ? foot : 0u;
  b.cur += alive ? 1 : 0;
  b.rsum = b.rsum + (alive ? 1.0f : 0.0f);
  // the next component's plane
  const bool placed_all = b.cur >= b.numc;
  const int ci = min(b.cur, p.components - 1);
  const bool square = ci >= 0 && ci < b.bad && !placed_all;
  if (FIRST) {
    uint32_t occ = 0u;
    if (n > 0) {
      occ = b.grid;
      for (int s = 1; s < n;) {
        const int d = min(s, n - s);
        occ |= seg_down(occ, d, sl);
        s += d;
      }
      for (int s = 1; s < n;) {
        const int d = min(s, n - s);
        occ |= seg_down(occ, d * p.row_stride, sl);
        s += d;
      }
    }
    b.pl = square ? ~occ & anchors : 0u;
  } else {
    const uint32_t kill =
        WHOLE ? ((unsigned)(g.row - xx + n - 1) < (unsigned)(2 * n - 1)
                     ? moved(g.kill, yy - n + 1 - g.col)
                     : 0u)
              : moved(g.kill, t - (n - 1) * (W + 1) - 32 * sl);
    b.pl = square ? b.pl & ~kill : 0u;
  }
  const bool empty = seg_ballot(b.pl != 0u, lane) == 0u;  // every lane
  const bool done = placed_all || empty || !alive;
  // on done, a fresh instance: an empty grid, n x n components, the anchors
  b.dcnt += done ? 1 : 0;
  b.grid = done ? 0u : b.grid;
  b.pl = done ? anchors : b.pl;
  b.cur = done ? 0 : b.cur;
  b.numc = done ? H * W : b.numc;
  b.bad = done ? p.components : b.bad;
  b.fresh = b.fresh || done;
}

// The chunk's steps (WHOLE: S is whole words). Lane sl draws the uniform
// of step t0 + sl every SEG steps (call 1 of the step, with its board's
// PRNG row and salt), and step t takes lane (t - t0)'s.
template <bool WHOLE>
__device__ __forceinline__ void square_steps(const FusedRolloutParams& p,
                                             Rng& rng, uint32_t blk_salt,
                                             int num_steps, int sl, int lane,
                                             int h0, int w0,
                                             SquareBoard& bd) {
  const int n = p.component_n;
  const int words = (p.height * p.row_stride + 31) >> 5;
  const SegWord g = seg_word<WHOLE>(p, sl);
  const uint32_t anchors =
      n <= p.height && n <= p.width ? flat_anchors(p, n, n, sl) : 0u;
  if (num_steps > 0) {
    rng.salt = step_salt(blk_salt, 0);
    square_step<true, WHOLE>(p, rng.uniform(1, 1, 0), g, anchors, sl, lane,
                             words, h0, w0, bd);
  }
  float ahead = 0.0f;
  for (int t = 1; t < num_steps; ++t) {
    const int i = (t - 1) & (SEG - 1);
    if (i == 0) {
      rng.salt = step_salt(blk_salt, t + sl);
      ahead = rng.uniform(1, 1, 0);
    }
    square_step<false, WHOLE>(p, __shfl_sync(FULL, ahead, i, SEG), g,
                              anchors, sl, lane, words, 0, 0, bd);
  }
}

// The chunk of the general square kernel for the four boards of a warp
// (segment lane / SEG is board bi). A segment past the batch takes part in
// every warp operation on empty leaves and writes nothing.
__device__ void square_general_chunk(const FusedRolloutParams& p,
                                     const FusedRolloutLeaves& in,
                                     const FusedRolloutLeaves& out,
                                     float* rsum_out, int32_t* dcnt_out,
                                     int bi, bool valid, int num_steps,
                                     int block, uint32_t seed, int lane) {
  const int sl = lane & (SEG - 1);
  const int A = p.height * p.width, C = p.components, P = p.pins;
  const int n = p.component_n;
  const int64_t b = bi;

  SquareBoard bd;
  bd.grid = seg_load(p, valid ? in.grid + b * A : nullptr, sl, lane);
  bd.pl = seg_load(p, valid ? in.plane0 + b * A : nullptr, sl, lane);
  bd.cur = valid ? in.cursor[b] : 0;
  bd.numc = valid ? in.num_components[b] : 0;
  int bad = C;
  for (int c = sl; valid && c < C; c += SEG)
    if (in.comp_h[b * C + c] != n || in.comp_w[b * C + c] != n)
      bad = min(bad, c);
#pragma unroll
  for (int d = 1; d < SEG; d <<= 1)
    bad = min(bad, __shfl_xor_sync(FULL, bad, d, SEG));
  bd.bad = bad;
  const int ci = min(bd.cur, C - 1);
  const int h0 = valid && ci >= 0 ? in.comp_h[b * C + ci] : 0;
  const int w0 = valid && ci >= 0 ? in.comp_w[b * C + ci] : 0;
  bd.rsum = 0.0f;
  bd.dcnt = 0;
  bd.fresh = false;

  Rng rng;
  rng.row = (uint32_t)(bi % block);
  const uint32_t blk_salt = block_salt(bi, block, seed);
  if (p.row_stride % 32 == 0)
    square_steps<true>(p, rng, blk_salt, num_steps, sl, lane, h0, w0, bd);
  else
    square_steps<false>(p, rng, blk_salt, num_steps, sl, lane, h0, w0, bd);

  // plane 1 copies plane 0 once a step has run
  const uint32_t pl1 = num_steps > 0
      ? bd.pl : seg_load(p, valid ? in.plane1 + b * A : nullptr, sl, lane);
  seg_store(p, valid ? out.grid + b * A : nullptr, bd.grid, sl);
  seg_store(p, valid ? out.plane0 + b * A : nullptr, bd.pl, sl);
  seg_store(p, valid ? out.plane1 + b * A : nullptr, pl1, sl);
  if (!valid) return;  // no warp operation follows
  for (int c = sl; c < C; c += SEG) {
    out.comp_h[b * C + c] = bd.fresh ? n : in.comp_h[b * C + c];
    out.comp_w[b * C + c] = bd.fresh ? n : in.comp_w[b * C + c];
  }
  // the pin leaves pass through; a regenerated board has none
  const auto pins_through = [&](int32_t* to, const int32_t* from) {
    for (int q = sl; q < P; q += SEG)
      to[b * P + q] = bd.fresh ? -1 : from[b * P + q];
  };
  pins_through(out.pin_rel_x, in.pin_rel_x);
  pins_through(out.pin_rel_y, in.pin_rel_y);
  pins_through(out.pin_abs_x, in.pin_abs_x);
  pins_through(out.pin_abs_y, in.pin_abs_y);
  pins_through(out.pin_net, in.pin_net);
  pins_through(out.pin_comp, in.pin_comp);
  if (sl == 0) {
    out.cursor[b] = bd.cur;
    out.num_components[b] = bd.numc;
    out.num_pins[b] = bd.fresh ? 0 : in.num_pins[b];
    rsum_out[b] = bd.rsum;
    dcnt_out[b] = bd.dcnt;
  }
}

// ---- the kernel ------------------------------------------------------------

template <int K, bool FLAT>
__global__ void __launch_bounds__(BLOCK_THREADS)
fused_rollout_reduced_kernel(FusedRolloutParams p, FusedRolloutLeaves in,
                             FusedRolloutLeaves out, float* rsum_out,
                             int32_t* dcnt_out, int batch, int num_steps,
                             int block, uint32_t seed) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if constexpr (K == K_SQUARE && FLAT) {
    const int first = (blockIdx.x * WARPS + warp) * SEG_BOARDS;
    if (first >= batch) return;  // the whole warp; no block barrier follows
    const int bi = first + lane / SEG;
    square_general_chunk(p, in, out, rsum_out, dcnt_out, bi, bi < batch,
                         num_steps, block, seed, lane);
    return;
  }
  const int bi = blockIdx.x * WARPS + warp;
  if (bi >= batch) return;  // the whole warp; no block barrier follows
  const int A = p.height * p.width, C = p.components, P = p.pins;
  const int64_t b = bi;

  ReducedBoard bd;
  bd.grid = load_rows<FLAT>(p, in.grid + b * A, lane);
  bd.pl0 = load_rows<FLAT>(p, in.plane0 + b * A, lane);
  bd.pl1 = load_rows<FLAT>(p, in.plane1 + b * A, lane);
  bd.n0 = plane_count(bd.pl0);
  bd.n1 = plane_count(bd.pl1);
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int c = lane + 32 * s;
    bd.ch[s] = c < C ? in.comp_h[b * C + c] : 0;
    bd.cw[s] = c < C ? in.comp_w[b * C + c] : 0;
  }
  bd.cur = in.cursor[b];
  bd.numc = in.num_components[b];
  bd.h = comp_at(bd.ch, bd.cur, C);
  bd.w = comp_at(bd.cw, bd.cur, C);
  bd.fresh = false;

  Rng rng;
  rng.row = (uint32_t)(bi % block);
  const uint32_t blk_salt = block_salt(bi, block, seed);
  float rsum = 0.0f;
  int dcnt = 0;
  for (int t = 0; t < num_steps; ++t) {
    rng.salt = step_salt(blk_salt, t);
    step<K, FLAT>(p, rng, bd, rsum, dcnt, lane);
  }

  store_rows<FLAT>(p, out.grid + b * A, bd.grid, lane);
  store_rows<FLAT>(p, out.plane0 + b * A, bd.pl0, lane);
  store_rows<FLAT>(p, out.plane1 + b * A, bd.pl1, lane);
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int c = lane + 32 * s;
    if (c < C) {
      out.comp_h[b * C + c] = bd.ch[s];
      out.comp_w[b * C + c] = bd.cw[s];
    }
  }
  // the pin leaves pass through; a regenerated board has none
  const auto pins_through = [&](int32_t* to, const int32_t* from) {
    for (int q = lane; q < P; q += 32)
      to[b * P + q] = bd.fresh ? -1 : from[b * P + q];
  };
  pins_through(out.pin_rel_x, in.pin_rel_x);
  pins_through(out.pin_rel_y, in.pin_rel_y);
  pins_through(out.pin_abs_x, in.pin_abs_x);
  pins_through(out.pin_abs_y, in.pin_abs_y);
  pins_through(out.pin_net, in.pin_net);
  pins_through(out.pin_comp, in.pin_comp);
  if (lane == 0) {
    out.cursor[b] = bd.cur;
    out.num_components[b] = bd.numc;
    out.num_pins[b] = bd.fresh ? 0 : in.num_pins[b];
    rsum_out[b] = rsum;
    dcnt_out[b] = dcnt;
  }
}

template <int K>
void launch(const FusedRolloutParams& p, const FusedRolloutLeaves& in,
            const FusedRolloutLeaves& out, float* rsum, int32_t* dcnt,
            int batch, int num_steps, int block, uint32_t seed,
            cudaStream_t stream) {
  const bool general = p.tier == T_GENERAL;
  const int boards = K == K_SQUARE && general ? WARPS * SEG_BOARDS : WARPS;
  const int grid = (batch + boards - 1) / boards;
  if (general)
    fused_rollout_reduced_kernel<K, true><<<grid, BLOCK_THREADS, 0, stream>>>(
        p, in, out, rsum, dcnt, batch, num_steps, block, seed);
  else
    fused_rollout_reduced_kernel<K, false><<<grid, BLOCK_THREADS, 0, stream>>>(
        p, in, out, rsum, dcnt, batch, num_steps, block, seed);
}

// Whether the instantiation that p.tier picks holds p's board and, for
// the pin kernels, its nets. The general square holds a board of at most
// SEG words; the wide tiers are the pin kernels' alone (T_WIDE6 the beam
// and "both" kernels'), and their tables and beam routes are held to their
// capacities here.
bool fits(const FusedRolloutParams& p) {
  const bool rows = p.height <= MAX_H && p.width <= MAX_W;
  if (p.tier == T_WIDE || p.tier == T_WIDE6)
    return p.kernel <= K_BOTH && rows && p.components <= WIDE_C &&
           p.nets <= WIDE_N && p.pins_per_net >= 1 &&
           p.pins_per_net <= WIDE_M && p.pins <= WIDE_P &&
           p.pins_per_component <= WIDE_PPC &&
           (p.kernel == K_CENTROID
                ? p.tier == T_WIDE
                : p.beam_width <= tier_beam_width(p.tier) &&
                      beam_slots(p.nets, p.pins_per_net) <= WIDE_BEAM_SLOTS);
  const bool general = p.tier == T_GENERAL;
  if (general && p.kernel == K_SQUARE && p.height * p.row_stride > 32 * SEG)
    return false;
  if (general) return rows || p.height * p.width <= MAX_AREA_LONG;
  return rows && (p.kernel >= K_SQUARE ||
                  (p.nets <= DEFAULT_N && p.pins_per_net <= DEFAULT_M));
}

}  // namespace

extern "C" {

// The kernel's fixed capacity named `what`, or -1 (the host checks these
// against KERNEL_CAPACITY in fused_rollout.py, the wide tier's,
// "wide.<name>", against WIDE_CAPACITY, and the wide6 tier's beam width
// against WIDE6_CAPACITY).
int fused_rollout_capacity(const char* what) {
  if (!strcmp(what, "wide.height")) return MAX_H;
  if (!strcmp(what, "wide.width")) return MAX_W;
  if (!strcmp(what, "wide.components")) return WIDE_C;
  if (!strcmp(what, "wide.nets")) return WIDE_N;
  if (!strcmp(what, "wide.pins_per_net")) return WIDE_M;
  if (!strcmp(what, "wide.pins")) return WIDE_P;
  if (!strcmp(what, "wide.pins_per_component")) return WIDE_PPC;
  if (!strcmp(what, "wide.beam_slots")) return WIDE_BEAM_SLOTS;
  if (!strcmp(what, "wide6.beam_width")) return WIDE6_BW;
  if (!strcmp(what, "height")) return MAX_H;
  if (!strcmp(what, "width")) return MAX_W;
  if (!strcmp(what, "area")) return MAX_AREA_LONG;
  if (!strcmp(what, "components")) return MAX_C;
  if (!strcmp(what, "nets")) return MAX_N;
  if (!strcmp(what, "pins_per_net")) return MAX_M;
  if (!strcmp(what, "pins")) return MAX_P;
  if (!strcmp(what, "pins_per_component")) return MAX_PPC;
  if (!strcmp(what, "components_nopin")) return MAX_C_NOPIN;
  if (!strcmp(what, "beam_width")) return MAX_BW;
  return -1;
}

// Boards of the pin kernel's instantiation that `params` selects (the
// instantiation of params->tier) one SM holds at once, or -1.
int fused_rollout_boards_per_sm(const FusedRolloutParams* params) {
  return params->kernel <= K_BOTH ? fused_rollout_warp_boards_per_sm(*params)
                                  : -1;
}

// Launches the chunk's specialisation `params->kernel` on `stream` and
// returns cudaGetLastError() (0 = ok). Does not synchronise; allocates
// nothing.
int fused_rollout_launch(const FusedRolloutParams* params,
                         const FusedRolloutLeaves* in,
                         const FusedRolloutLeaves* out, float* rsum,
                         int32_t* dcnt, int batch, int num_steps, int block,
                         uint32_t seed, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (!fits(*params)) return (int)cudaErrorInvalidValue;
  switch (params->kernel) {
    case K_CENTROID:  // the pin kernels: one warp per board,
    case K_BEAM:      // fused_rollout_warp.cu
    case K_BOTH:
      return fused_rollout_warp_launch(*params, *in, *out, rsum, dcnt,
                                       batch, num_steps, block, seed, st);
    case K_SQUARE:
      launch<K_SQUARE>(*params, *in, *out, rsum, dcnt, batch, num_steps,
                       block, seed, st);
      break;
    case K_RECT:
      launch<K_RECT>(*params, *in, *out, rsum, dcnt, batch, num_steps, block,
                     seed, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"

// Fused rollout chunk of the reduced kernels, one warp per board, and the C
// entry points of the kernel library.
//
// Replaces the Pallas TPU kernel of placement_tpu/ops/fused_rollout.py
// (make_fused_rollout's pl.pallas_call at :866, body _build_kernel
// :290-763) for the SQUARE and RECT environments (generate :364-397, the
// step's sampling :610-643 and reward :711-713): two instantiations of
// fused_rollout_reduced_kernel<K, FLAT> each (enum Kernel in
// fused_common.cuh), a grid row per lane (sides <= 32) and, for a board
// with a side over 32, its bit string over the lanes (fused_warp.cuh).
// No pin tables, +1 per placement, one (SQUARE) or two (RECT) orientation
// planes. The pin kernels (K_CENTROID, K_BEAM, K_BOTH) are
// fused_rollout_warp.cu's; fused_rollout_launch below dispatches to them.
// A warp runs the whole num_steps chunk of its board: random legal-action
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
//     (row, column) pair, so no step divides by the grid's width;
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

// ---- the kernel ------------------------------------------------------------

template <int K, bool FLAT>
__global__ void __launch_bounds__(BLOCK_THREADS)
fused_rollout_reduced_kernel(FusedRolloutParams p, FusedRolloutLeaves in,
                             FusedRolloutLeaves out, float* rsum_out,
                             int32_t* dcnt_out, int batch, int num_steps,
                             int block, uint32_t seed) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
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
  const int grid = (batch + WARPS - 1) / WARPS;
  if (p.general)
    fused_rollout_reduced_kernel<K, true><<<grid, BLOCK_THREADS, 0, stream>>>(
        p, in, out, rsum, dcnt, batch, num_steps, block, seed);
  else
    fused_rollout_reduced_kernel<K, false><<<grid, BLOCK_THREADS, 0, stream>>>(
        p, in, out, rsum, dcnt, batch, num_steps, block, seed);
}

// Whether the instantiation that p.general picks holds p's board and, for
// the pin kernels, its nets.
bool fits(const FusedRolloutParams& p) {
  const bool rows = p.height <= MAX_H && p.width <= MAX_W;
  if (p.general) return rows || p.height * p.width <= MAX_AREA_LONG;
  return rows && (p.kernel >= K_SQUARE ||
                  (p.nets <= DEFAULT_N && p.pins_per_net <= DEFAULT_M));
}

}  // namespace

extern "C" {

// The kernel's fixed capacity named `what`, or -1 (the host checks these
// against KERNEL_CAPACITY in fused_rollout.py).
int fused_rollout_capacity(const char* what) {
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

// Fused rollout chunk of the reduced kernels, one thread per board, and the
// C entry points of the kernel library.
//
// Replaces the Pallas TPU kernel of placement_tpu/ops/fused_rollout.py
// (make_fused_rollout's pl.pallas_call, kernel body _build_kernel) for the
// SQUARE and RECT environments: one instantiation of the template
// fused_rollout_kernel<K> each (enum Kernel in fused_common.cuh). No pin
// tables, +1 per placement, one (SQUARE) or two (RECT) orientation planes.
// The pin kernels (K_CENTROID, K_BEAM, K_BOTH) run one warp per board in
// fused_rollout_warp.cu; fused_rollout_launch below dispatches to them.
// Each thread runs the whole num_steps chunk of its board: random
// legal-action sampling, placement, the next legality planes, the done
// test, and on episode end the regeneration of a fresh instance.
//
// What bounds it on an H100: per-board integer work and local-memory
// traffic, not device-memory bandwidth. A chunk reads and writes each
// board's state once; everything in between is branchy scalar work on the
// per-thread mask and component tables (912 B a frame). At the flagship
// size there are only 4096 boards, so only 4096 threads: about one warp
// per SM scheduler, and latency is hidden by nothing but each thread's own
// instruction-level parallelism.
//
// What the design does about it: the TPU layout ([block, F] rows, [A, A]
// cover and prefix matmuls, lane gathers) is not carried over. Occupancy
// and legality planes are 32-bit row masks, so a footprint test is a few
// ORs and shifts per row, a plane count is popcounts, and the sampled anchor
// is found by popcount and bit clearing. Random numbers are drawn only by
// boards that finish (the JAX kernel's lax.cond over the block computes the
// same per-board values).
//
// Semantics kept bit for bit with the JAX kernel: the counter-hash PRNG
// (_mix/_Rng) with the LOGICAL block of make_fused_rollout's `block`
// argument in the salt, the draw order (call 1 in the step; 2..4 in RECT's
// generator, none in SQUARE's). Build with -fmad=false and without
// --use_fast_math, as the pin kernels need.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "fused_common.cuh"

namespace {

constexpr int THREADS = 128;

// A board of the reduced kernels: no pin tables. Its pin leaves pass
// through unchanged until the board is regenerated (`fresh`), which writes
// them as -1 with num_pins = 0.
struct Board {
  uint32_t grid[MAX_H];            // bit y of row x = cell x*W + y occupied
  uint32_t pl0[MAX_H], pl1[MAX_H]; // legality planes, same layout
  int32_t ch[MAX_C_NOPIN], cw[MAX_C_NOPIN];
  int32_t cur, numc;
  bool fresh;
};

// ---- legality planes (planes_for) ----------------------------------------

// The footprints the kernel has planes for (_build_kernel's `combos`):
// SQUARE's n x n, otherwise the component ranges and their transposes.
template <int K>
__device__ __forceinline__ bool in_footprints(const FusedRolloutParams& p,
                                              int h, int w) {
  if (K == K_SQUARE) return h == p.component_n && w == p.component_n;
  return (h >= p.min_h && h <= p.max_h && w >= p.min_w && w <= p.max_w) ||
         (w >= p.min_h && w <= p.max_h && h >= p.min_w && h <= p.max_w);
}

// Anchors where an (ph, pw) footprint is in bounds and covers no occupied
// cell; a footprint outside the config's set gives a zero plane.
template <int K>
__device__ void free_plane(const FusedRolloutParams& p, const uint32_t* grid,
                           int ph, int pw, uint32_t* out) {
  const int H = p.height, W = p.width;
  const bool known = in_footprints<K>(p, ph, pw) && pw <= W;
  const int nanchor = W - pw + 1;
  const uint32_t anchors =
      nanchor >= 32 ? 0xffffffffu : ((1u << max(nanchor, 0)) - 1u);
  for (int x = 0; x < H; ++x) {
    if (!known || x + ph > H) {
      out[x] = 0u;
      continue;
    }
    uint32_t occ = 0u;
    for (int dx = 0; dx < ph; ++dx) occ |= grid[x + dx];
    uint32_t dil = 0u;
    for (int dy = 0; dy < pw; ++dy) dil |= occ >> dy;
    out[x] = ~dil & anchors;
  }
}

template <int K>
__device__ void planes_for(const FusedRolloutParams& p, Board& b, int ch_c,
                           int cw_c, bool alive) {
  if (!alive) {
    for (int x = 0; x < p.height; ++x) b.pl0[x] = b.pl1[x] = 0u;
    return;
  }
  free_plane<K>(p, b.grid, ch_c, cw_c, b.pl0);
  if (K == K_SQUARE) {
    // (w, h) is the same footprint: SQUARE's plane 1 equals plane 0
    for (int x = 0; x < p.height; ++x) b.pl1[x] = b.pl0[x];
  } else {
    free_plane<K>(p, b.grid, cw_c, ch_c, b.pl1);
  }
}

__device__ __forceinline__ int plane_count(const FusedRolloutParams& p,
                                           const uint32_t* pl) {
  int c = 0;
  for (int x = 0; x < p.height; ++x) c += __popc(pl[x]);
  return c;
}

// Row-major index of the k-th (0-based) legal cell; A-1 if there is none
// (the JAX kernel's count of prefix sums <= k, capped at A-1).
__device__ int nth_cell(const FusedRolloutParams& p, const uint32_t* pl,
                        int k) {
  for (int x = 0; x < p.height; ++x) {
    const int c = __popc(pl[x]);
    if (k < c) {
      uint32_t m = pl[x];
      for (int i = 0; i < k; ++i) m &= m - 1u;
      return x * p.width + (__ffs(m) - 1);
    }
    k -= c;
  }
  return p.height * p.width - 1;
}

__device__ __forceinline__ int comp_at(const int32_t* t, int i, int C) {
  i = min(i, C - 1);
  return i >= 0 ? t[i] : 0;
}

// ---- in-kernel instance generator (generate) -----------------------------

// The reduced kernels' generator (generate, :364-397): SQUARE's unlimited
// supply of n x n components draws nothing; RECT draws heights (call 2),
// widths (call 3) and the count (call 4).
template <int K>
__device__ void generate(const FusedRolloutParams& p, const Rng& rng,
                               Board& b) {
  const int C = p.components;
  if (K == K_SQUARE) {
    for (int c = 0; c < C; ++c) b.ch[c] = b.cw[c] = p.component_n;
    b.numc = p.height * p.width;
  } else {
    b.numc = randint(p.min_c, p.max_c, rng.uniform(4, 1, 0));
    for (int c = 0; c < C; ++c) {
      int h = randint(p.min_h, p.max_h, rng.uniform(2, C, c));
      int w = randint(p.min_w, p.max_w, rng.uniform(3, C, c));
      if (c >= b.numc) h = w = 0;
      b.ch[c] = h;
      b.cw[c] = w;
    }
  }
  for (int x = 0; x < p.height; ++x) b.grid[x] = 0u;
  b.cur = 0;
  b.fresh = true;
  planes_for<K>(p, b, b.ch[0], b.cw[0], true);
}

// ---- one step (body) -----------------------------------------------------

// Samples a legal action: its orientation `osel` and anchor cell `idx`
// (:610-643): RECT draws over two planes, SQUARE over one. Returns whether
// any action was legal.
template <int K>
__device__ __forceinline__ bool sample_action(const FusedRolloutParams& p,
                                              const Rng& rng, const Board& b,
                                              int& osel, int& idx) {
  const int c0 = plane_count(p, b.pl0);
  const int c1 = K == K_SQUARE ? 0 : plane_count(p, b.pl1);
  const float total = (float)(c0 + c1);
  const float u = rng.uniform(1, 1, 0);
  float tgt = fminf(floorf(u * total), total - 1.0f);
  tgt = fmaxf(tgt, 0.0f);
  const float pre1 = (float)c0;
  float tin = tgt;
  osel = 0;
  if (K == K_RECT) {
    osel = tgt >= pre1;
    tin = tgt - (osel == 0 ? 0.0f : pre1);
  }
  idx = nth_cell(p, osel % 2 == 0 ? b.pl0 : b.pl1, (int)tin);
  return total > 0.0f;
}

// Marks the (ph, pw) footprint anchored at cell idx as occupied.
__device__ __forceinline__ void paint(const FusedRolloutParams& p, Board& b,
                                      int idx, int ph, int pw) {
  const int H = p.height, W = p.width;
  const int xx = idx / W, yy = idx % W;
  const uint64_t wmask = (1ull << W) - 1ull;
  const uint32_t cols =
      (uint32_t)(((((1ull << max(pw, 0)) - 1ull) << yy)) & wmask);
  for (int x = xx; x < min(xx + ph, H); ++x) b.grid[x] |= cols;
}

// The reduced kernels' step: +1 per successful placement, terminal or not
// (:711-713), no pins to rotate.
template <int K>
__device__ void step(const FusedRolloutParams& p, const Rng& rng,
                           Board& b, float& rsum, int& dcnt) {
  const int C = p.components;
  int osel, idx;
  const bool alive = sample_action<K>(p, rng, b, osel, idx);
  if (alive) {
    const int chc = comp_at(b.ch, b.cur, C), cwc = comp_at(b.cw, b.cur, C);
    const bool even = osel % 2 == 0;
    paint(p, b, idx, even ? chc : cwc, even ? cwc : chc);
    ++b.cur;
    rsum = rsum + 1.0f;
  }
  const bool placed_all = b.cur >= b.numc;
  planes_for<K>(p, b, comp_at(b.ch, b.cur, C), comp_at(b.cw, b.cur, C),
                !placed_all);
  const int nt = plane_count(p, b.pl0) + plane_count(p, b.pl1);
  const bool done = placed_all || nt == 0 || !alive;
  if (!done) return;
  ++dcnt;
  generate<K>(p, rng, b);
}

// ---- the kernel ------------------------------------------------------------

__device__ void load_masks(const FusedRolloutParams& p,
                           const FusedRolloutLeaves& in, int64_t b,
                           Board& m) {
  const int H = p.height, W = p.width, A = H * W;
  for (int x = 0; x < H; ++x) {
    uint32_t g = 0u, m0 = 0u, m1 = 0u;
    for (int y = 0; y < W; ++y) {
      const int64_t a = b * A + x * W + y;
      g |= (uint32_t)(in.grid[a] != 0.0f) << y;
      m0 |= (uint32_t)(in.plane0[a] != 0.0f) << y;
      m1 |= (uint32_t)(in.plane1[a] != 0.0f) << y;
    }
    m.grid[x] = g;
    m.pl0[x] = m0;
    m.pl1[x] = m1;
  }
}

__device__ void store_masks(const FusedRolloutParams& p,
                            const FusedRolloutLeaves& out, int64_t b,
                            const Board& m) {
  const int H = p.height, W = p.width, A = H * W;
  for (int x = 0; x < H; ++x) {
    for (int y = 0; y < W; ++y) {
      const int64_t a = b * A + x * W + y;
      out.grid[a] = (float)((m.grid[x] >> y) & 1u);
      out.plane0[a] = (float)((m.pl0[x] >> y) & 1u);
      out.plane1[a] = (float)((m.pl1[x] >> y) & 1u);
    }
  }
}

template <int K>
__global__ void __launch_bounds__(THREADS)
fused_rollout_kernel(FusedRolloutParams p, FusedRolloutLeaves in,
                     FusedRolloutLeaves out, float* rsum_out,
                     int32_t* dcnt_out, int batch, int num_steps, int block,
                     uint32_t seed) {
  const int bi = blockIdx.x * blockDim.x + threadIdx.x;
  if (bi >= batch) return;
  const int C = p.components, P = p.pins;
  const int64_t b = bi;
  Board bd;
  load_masks(p, in, b, bd);
  for (int c = 0; c < C; ++c) {
    bd.ch[c] = in.comp_h[b * C + c];
    bd.cw[c] = in.comp_w[b * C + c];
  }
  bd.cur = in.cursor[b];
  bd.numc = in.num_components[b];
  bd.fresh = false;

  Rng rng;
  rng.row = (uint32_t)(bi % block);
  const uint32_t blk_salt = block_salt(bi, block, seed);
  float rsum = 0.0f;
  int dcnt = 0;
  for (int t = 0; t < num_steps; ++t) {
    rng.salt = step_salt(blk_salt, t);
    step<K>(p, rng, bd, rsum, dcnt);
  }

  store_masks(p, out, b, bd);
  for (int c = 0; c < C; ++c) {
    out.comp_h[b * C + c] = bd.ch[c];
    out.comp_w[b * C + c] = bd.cw[c];
  }
  out.cursor[b] = bd.cur;
  out.num_components[b] = bd.numc;
  // the pin leaves pass through; a regenerated board has none
  out.num_pins[b] = bd.fresh ? 0 : in.num_pins[b];
  int32_t* const outs[6] = {out.pin_rel_x, out.pin_rel_y, out.pin_abs_x,
                            out.pin_abs_y, out.pin_net,   out.pin_comp};
  const int32_t* const ins[6] = {in.pin_rel_x, in.pin_rel_y, in.pin_abs_x,
                                 in.pin_abs_y, in.pin_net,   in.pin_comp};
  for (int l = 0; l < 6; ++l)
    for (int q = 0; q < P; ++q)
      outs[l][b * P + q] = bd.fresh ? -1 : ins[l][b * P + q];
  rsum_out[b] = rsum;
  dcnt_out[b] = dcnt;
}

template <int K>
void launch(const FusedRolloutParams& p, const FusedRolloutLeaves& in,
            const FusedRolloutLeaves& out, float* rsum, int32_t* dcnt,
            int batch, int num_steps, int block, uint32_t seed,
            cudaStream_t stream) {
  const int grid = (batch + THREADS - 1) / THREADS;
  fused_rollout_kernel<K><<<grid, THREADS, 0, stream>>>(
      p, in, out, rsum, dcnt, batch, num_steps, block, seed);
}

}  // namespace

extern "C" {

// The kernel's fixed capacity named `what`, or -1 (the host checks these
// against KERNEL_CAPACITY in fused_rollout.py).
int fused_rollout_capacity(const char* what) {
  if (!strcmp(what, "height")) return MAX_H;
  if (!strcmp(what, "width")) return MAX_W;
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

// Fused rollout chunk for the pin environment, one thread per board.
//
// Replaces the Pallas TPU kernel of placement_tpu/ops/fused_rollout.py
// (make_fused_rollout's pl.pallas_call, kernel body _build_kernel), the
// PIN / PIN_SPATIAL specialisation with the centroid routing reward
// (placement_tpu/ops/fused_routing.py::centroid_wl_int via reward_rows) and
// min_num_pins_per_net == max_num_pins_per_net. Each thread runs the whole
// num_steps chunk of its board: random legal-action sampling, placement and
// pin rotation, the next legality planes, the done test, the terminal
// reward, and on episode end the regeneration of a fresh instance.
//
// What bounds it on an H100: per-board integer work and local-memory
// traffic, not device-memory bandwidth. A chunk reads and writes each
// board's ~2.4 KB of state once; everything in between is branchy scalar
// work on per-thread tables (the pin table, the allocation tables). At the
// flagship size there are only 4096 boards, so only 4096 threads: about one
// warp per SM scheduler, and latency is hidden by nothing but each thread's
// own instruction-level parallelism.
//
// What the design does about it: the TPU layout ([block, F] rows, [A, A]
// cover and prefix matmuls, lane gathers) is not carried over. Occupancy
// and legality planes are 32-bit row masks, so a footprint test is a few
// ORs and shifts per row, a plane count is popcounts, and the sampled anchor
// is found by popcount and bit clearing. Random numbers are drawn only by
// boards that finish (the JAX kernel's lax.cond over the block computes the
// same per-board values), and only the cells that are used are drawn.
//
// Semantics kept bit for bit with the JAX kernel: the counter-hash PRNG
// (_mix/_Rng) with the LOGICAL block of make_fused_rollout's `block`
// argument in the salt, the draw order (call numbers 1..7+N), stable sorts,
// in-order water-fills, true f32 division in the allocation, and the f32
// operation order of the routing reward. Build with -fmad=false and without
// --use_fast_math so no FMA contraction or approximate division changes a
// rounding.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int MAX_H = 32;     // grid rows are 32-bit masks
constexpr int MAX_W = 32;
constexpr int MAX_C = 8;      // components
constexpr int MAX_N = 8;      // nets
constexpr int MAX_M = 16;     // pins per net
constexpr int MAX_P = 48;     // pin-table length
constexpr int MAX_PPC = 16;   // pins (cells) per component
constexpr int THREADS = 128;

static_assert(MAX_W <= 32, "a grid row must fit one 32-bit mask");
static_assert(MAX_H * MAX_W <= (1 << 24), "cell counts must be exact in f32");
static_assert(MAX_N * MAX_M <= 256, "per-net allocation table size");
static_assert(MAX_C * MAX_PPC <= 256, "per-component cell table size");

}  // namespace

extern "C" {

// Mirrored by _KernelParams in placement_tpu_torch/ops/fused_rollout.py.
struct FusedRolloutParams {
  int32_t height, width;
  int32_t components, nets, pins_per_net, pins, pins_per_component;
  int32_t min_h, max_h, min_w, max_w;
  int32_t min_c, max_c, min_n, max_n;
  int32_t ppn;          // pins per net (min == max)
  int32_t spatial;      // PIN_SPATIAL's k0 formula
  int32_t pin_spread;
  float lam_w, lam_i, wl_norm, int_norm, penalty;
};

// One device pointer per leaf, in the order of _LEAVES.
struct FusedRolloutLeaves {
  float* grid;
  int32_t* comp_h;
  int32_t* comp_w;
  int32_t* cursor;
  int32_t* num_components;
  int32_t* pin_rel_x;
  int32_t* pin_rel_y;
  int32_t* pin_abs_x;
  int32_t* pin_abs_y;
  int32_t* pin_net;
  int32_t* pin_comp;
  int32_t* num_pins;
  float* plane0;
  float* plane1;
};

}  // extern "C"

namespace {

struct Board {
  uint32_t grid[MAX_H];            // bit y of row x = cell x*W + y occupied
  uint32_t pl0[MAX_H], pl1[MAX_H]; // legality planes, same layout
  int32_t ch[MAX_C], cw[MAX_C];
  int32_t cur, numc, npin;
  int32_t prx[MAX_P], pry[MAX_P], pax[MAX_P], pay[MAX_P];
  int32_t pnet[MAX_P], pcomp[MAX_P];
};

// ---- counter-hash PRNG (fused_rollout.py _mix / _Rng) -------------------

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

struct Rng {
  uint32_t salt;  // mixed
  uint32_t row;   // board index within its logical block

  // Element (row, col) of the n-th draw of shape (block, width).
  __device__ float uniform(uint32_t n, uint32_t width, uint32_t col) const {
    const uint32_t call = n * 2654435761u;
    const uint32_t bits = mix32((row * width + col) ^ mix32(call ^ salt));
    return (float)(bits >> 8) * (1.0f / 16777216.0f);
  }
};

__device__ __forceinline__ int randint(int lo, int hi, float u) {
  const int span = hi - lo + 1;
  const int draw = (int)floorf(u * (float)span);
  return lo + min(draw, span - 1);
}

// ---- legality planes (planes_for) ----------------------------------------

__device__ __forceinline__ bool in_footprints(const FusedRolloutParams& p,
                                              int h, int w) {
  return (h >= p.min_h && h <= p.max_h && w >= p.min_w && w <= p.max_w) ||
         (w >= p.min_h && w <= p.max_h && h >= p.min_w && h <= p.max_w);
}

// Anchors where an (ph, pw) footprint is in bounds and covers no occupied
// cell; a footprint outside the config's set gives a zero plane.
__device__ void free_plane(const FusedRolloutParams& p, const uint32_t* grid,
                           int ph, int pw, uint32_t* out) {
  const int H = p.height, W = p.width;
  const bool known = in_footprints(p, ph, pw) && pw <= W;
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

__device__ void planes_for(const FusedRolloutParams& p, Board& b, int ch_c,
                           int cw_c, bool alive) {
  if (!alive) {
    for (int x = 0; x < p.height; ++x) b.pl0[x] = b.pl1[x] = 0u;
    return;
  }
  free_plane(p, b.grid, ch_c, cw_c, b.pl0);
  free_plane(p, b.grid, cw_c, ch_c, b.pl1);
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

// ---- centroid routing reward (fused_routing.centroid_wl_int) -------------

__device__ bool seg_intersect(float ax1, float ay1, float ax2, float ay2,
                              float bx1, float by1, float bx2, float by2) {
  const bool same = (ax1 == bx1 && ay1 == by1) || (ax1 == bx2 && ay1 == by2) ||
                    (ax2 == bx1 && ay2 == by1) || (ax2 == bx2 && ay2 == by2);
  const float det = (ax1 - ax2) * (by1 - by2) - (ay1 - ay2) * (bx1 - bx2);
  const float o1 = (ax2 - ax1) * (by1 - ay1) - (ay2 - ay1) * (bx1 - ax1);
  const float o2 = (ax2 - ax1) * (by2 - ay1) - (ay2 - ay1) * (bx2 - ax1);
  const float o3 = (bx2 - bx1) * (ay1 - by1) - (by2 - by1) * (ax1 - bx1);
  const float o4 = (bx2 - bx1) * (ay2 - by1) - (by2 - by1) * (ax2 - bx1);
  const bool opp_b = (o1 >= 0.f && o2 <= 0.f) || (o1 <= 0.f && o2 >= 0.f);
  const bool opp_a = (o3 >= 0.f && o4 <= 0.f) || (o3 <= 0.f && o4 >= 0.f);
  return same || (det != 0.f && opp_b && opp_a);
}

__device__ float centroid_reward(const FusedRolloutParams& p, const Board& b) {
  const int N = p.nets, P = p.pins;
  int cnt[MAX_N], start[MAX_N];
  float sx[MAX_N], sy[MAX_N], cx[MAX_N], cy[MAX_N], x2nd[MAX_N], y2nd[MAX_N];
  for (int n = 0; n < N; ++n) {
    cnt[n] = 0;
    sx[n] = sy[n] = x2nd[n] = y2nd[n] = 0.f;
  }
  for (int q = 0; q < P; ++q) {
    const int n = b.pnet[q];
    if (q < b.npin && n >= 0 && n < N) {
      ++cnt[n];
      sx[n] += (float)b.pax[q];
      sy[n] += (float)b.pay[q];
    }
  }
  int run = 0;
  for (int n = 0; n < N; ++n) {
    const float denom = (float)max(cnt[n], 1);
    cx[n] = sx[n] / denom;
    cy[n] = sy[n] / denom;
    start[n] = run;
    run += cnt[n];
  }
  for (int q = 0; q < P; ++q) {  // second pin of each net (2-pin routes)
    const int n = b.pnet[q];
    if (q < b.npin && n >= 0 && n < N && q - start[n] == 1) {
      x2nd[n] = (float)b.pax[q];
      y2nd[n] = (float)b.pay[q];
    }
  }
  // per-pin segments: integer-scaled endpoints for the exact predicate
  float x1s[MAX_P], y1s[MAX_P], x2s[MAX_P], y2s[MAX_P], s[MAX_P];
  bool sv[MAX_P];
  float wl = 0.f;
  for (int q = 0; q < P; ++q) {
    const float x = (float)b.pax[q], y = (float)b.pay[q];
    const int n = b.pnet[q];
    float ex = 0.f, ey = 0.f, exs = 0.f, eys = 0.f, sc = 1.f;
    bool valid = false;
    if (q < b.npin && n >= 0 && n < N) {
      const bool two = cnt[n] == 2;
      ex = two ? x2nd[n] : cx[n];
      ey = two ? y2nd[n] : cy[n];
      exs = two ? x2nd[n] : sx[n];
      eys = two ? y2nd[n] : sy[n];
      sc = two ? 1.f : (float)max(cnt[n], 1);
      valid = !two || q - start[n] == 0;
    }
    if (valid) {
      const float dx = x - ex, dy = y - ey;
      wl += sqrtf(dx * dx + dy * dy);
    }
    x1s[q] = x * sc;
    y1s[q] = y * sc;
    x2s[q] = exs;
    y2s[q] = eys;
    s[q] = sc;
    sv[q] = valid;
  }
  int ints = 0;
  for (int q = 0; q < P; ++q) {
    if (!sv[q]) continue;
    for (int r = q + 1; r < P; ++r) {
      if (!sv[r] || b.pnet[r] == b.pnet[q]) continue;
      ints += seg_intersect(x1s[q] * s[r], y1s[q] * s[r], x2s[q] * s[r],
                            y2s[q] * s[r], x1s[r] * s[q], y1s[r] * s[q],
                            x2s[r] * s[q], y2s[r] * s[q]);
    }
  }
  return -(p.lam_w * (wl / p.wl_norm) + p.lam_i * ((float)ints / p.int_norm));
}

// ---- in-kernel instance generator (generate, pin branch) -----------------

// One net's pin -> component allocation; writes the component of each of
// the net's M ranks to `comp_of` and updates `space` when the net is open.
__device__ void allocate_net(const FusedRolloutParams& p, const Rng& rng,
                             int n, int m, int k0, bool open, int* space,
                             int* comp_of) {
  const int C = p.components, M = p.pins_per_net;
  // components by free space, descending; keys space*(C+1)+(C-1-i) are
  // unique, so any correct sort gives the bubble network's order
  int s_idx[MAX_C], s_space[MAX_C];
  for (int i = 0; i < C; ++i) {
    const int key = space[i] * (C + 1) + (C - 1 - i);
    int j = i;
    while (j > 0 &&
           space[s_idx[j - 1]] * (C + 1) + (C - 1 - s_idx[j - 1]) < key) {
      s_idx[j] = s_idx[j - 1];
      --j;
    }
    s_idx[j] = i;
  }
  int not_enough = 0, csum = 0;
  for (int c = 0; c < C; ++c) {
    s_space[c] = space[s_idx[c]];
    csum += s_space[c];
    not_enough += csum < m;
  }
  const int k = max(k0, min(not_enough + 1, C));
  float cw_cum[MAX_C];
  float tot_w = 0.f;
  for (int c = 0; c < C; ++c) {
    tot_w += c < k ? (float)s_space[c] : 0.f;
    cw_cum[c] = tot_w;
  }
  tot_w = fmaxf(tot_w, 1e-9f);
  int cnt[MAX_C];
  for (int c = 0; c < C; ++c) cnt[c] = 0;
  for (int j = 0; j < m; ++j) {
    const float ut = rng.uniform(7 + n, M, j);
    int bin = 0;
    for (int c = 0; c < C - 1; ++c) bin += ut > cw_cum[c] / tot_w;
    ++cnt[bin];
  }
  int got = 0;
  for (int c = 0; c < C; ++c) {
    cnt[c] = min(cnt[c], s_space[c]);
    got += cnt[c];
  }
  // in-order water-fill of the residue into the remaining space
  const int resid = m - got;
  int before = 0;
  for (int c = 0; c < C; ++c) {
    const int free_c = s_space[c] - cnt[c];
    cnt[c] += min(max(resid - before, 0), free_c);
    before += free_c;
  }
  int bound[MAX_C];
  int acc = 0;
  for (int c = 0; c < C; ++c) bound[c] = acc += cnt[c];
  for (int j = 0; j < M; ++j) {
    int slot = 0;
    for (int c = 0; c < C; ++c) slot += j >= bound[c];
    comp_of[j] = s_idx[min(slot, C - 1)];
  }
  if (open)
    for (int c = 0; c < C; ++c) space[s_idx[c]] = s_space[c] - cnt[c];
}

__device__ void generate(const FusedRolloutParams& p, const Rng& rng,
                         Board& b) {
  const int C = p.components, N = p.nets, M = p.pins_per_net, P = p.pins;
  const int PPC = p.pins_per_component;
  // draws 2, 3, 4: component heights, widths, count
  b.numc = randint(p.min_c, p.max_c, rng.uniform(4, 1, 0));
  int area[MAX_C], space[MAX_C];
  int total_area = 0;
  for (int c = 0; c < C; ++c) {
    int h = randint(p.min_h, p.max_h, rng.uniform(2, C, c));
    int w = randint(p.min_w, p.max_w, rng.uniform(3, C, c));
    if (c >= b.numc) h = w = 0;
    b.ch[c] = h;
    b.cw[c] = w;
    area[c] = space[c] = h * w;
    total_area += h * w;
  }
  // draw 5: net count; draw 6 (total pins) feeds only the
  // max_ppn > min_ppn allocation, which this kernel does not cover
  int nn = randint(p.min_n, p.max_n, rng.uniform(5, 1, 0));
  nn = max(min(nn, total_area / 2), 1);
  int ncum[MAX_N];
  int num_pins = 0;
  for (int n = 0; n < N; ++n) ncum[n] = num_pins += n < nn ? p.ppn : 0;
  b.npin = num_pins;

  int k0 = p.spatial ? (p.pin_spread * b.numc) / 10 + 1
                     : max(((p.pin_spread + 1) * b.numc) / 10, 1);
  k0 = min(k0, b.numc);
  int table[MAX_N * MAX_M];
  for (int n = 0; n < N; ++n)  // draws 7 .. 6+N
    allocate_net(p, rng, n, n < nn ? p.ppn : 0, k0, n < nn, space,
                 table + n * M);

  // draw 7+N: a random cell order per component, stable ascending sort of
  // uniform scores with unused cells scored 2.0
  int cell_table[MAX_C * MAX_PPC];
  for (int c = 0; c < C; ++c) {
    float sc[MAX_PPC];
    int* perm = cell_table + c * PPC;
    for (int k = 0; k < PPC; ++k) {
      const float v = k < area[c] ? rng.uniform(7 + N, C * PPC, c * PPC + k)
                                  : 2.0f;
      int j = k;
      while (j > 0 && sc[j - 1] > v) {
        sc[j] = sc[j - 1];
        perm[j] = perm[j - 1];
        --j;
      }
      sc[j] = v;
      perm[j] = k;
    }
  }

  int ccount[MAX_C];
  for (int c = 0; c < C; ++c) ccount[c] = 0;
  const int wlo = max(p.min_w, 1);
  for (int q = 0; q < P; ++q) {
    int net = 0;
    for (int n = 0; n < N; ++n) net += q >= ncum[n];
    const int nc = min(net, N - 1);
    const int rank = q - (nc > 0 ? ncum[nc - 1] : 0);
    const bool in_use = q < num_pins;
    const int comp =
        in_use ? table[nc * M + min(max(rank, 0), M - 1)] : -1;
    int r = 0;
    if (comp >= 0 && comp < C) r = ccount[comp]++;
    const int cell =
        cell_table[max(comp, 0) * PPC + min(max(r, 0), PPC - 1)];
    const int wp = b.cw[max(comp, 0)];
    int rx = 0, ry = 0;
    if (wp >= wlo && wp <= p.max_w) {
      rx = cell / wp;
      ry = cell % wp;
    }
    b.prx[q] = comp >= 0 ? rx : -1;
    b.pry[q] = comp >= 0 ? ry : -1;
    b.pax[q] = b.pay[q] = -1;
    b.pnet[q] = in_use ? net : -1;
    b.pcomp[q] = comp;
  }
  for (int x = 0; x < p.height; ++x) b.grid[x] = 0u;
  b.cur = 0;
  planes_for(p, b, b.ch[0], b.cw[0], true);
}

// ---- one step (body) -----------------------------------------------------

__device__ void step(const FusedRolloutParams& p, const Rng& rng, Board& b,
                     float& rsum, int& dcnt) {
  const int H = p.height, W = p.width, C = p.components, P = p.pins;
  const int c0 = plane_count(p, b.pl0), c1 = plane_count(p, b.pl1);
  const float total = 2.0f * (float)(c0 + c1);  // planes 2, 3 copy 0, 1
  const bool alive = total > 0.0f;

  const float u = rng.uniform(1, 1, 0);
  float tgt = fminf(floorf(u * total), total - 1.0f);
  tgt = fmaxf(tgt, 0.0f);
  const float pre1 = (float)c0, pre2 = (float)(c0 + c1);
  const float pre3 = pre2 + (float)c0;
  const int osel = (tgt >= pre1) + (tgt >= pre2) + (tgt >= pre3);
  const float tin = tgt - (osel == 0   ? 0.0f
                           : osel == 1 ? pre1
                           : osel == 2 ? pre2
                                       : pre3);
  const bool even = osel % 2 == 0;
  const int idx = nth_cell(p, even ? b.pl0 : b.pl1, (int)tin);
  const int xx = idx / W, yy = idx % W;

  const int chc = comp_at(b.ch, b.cur, C), cwc = comp_at(b.cw, b.cur, C);
  if (alive) {
    const int ph = even ? chc : cwc, pw = even ? cwc : chc;
    const uint64_t wmask = (1ull << W) - 1ull;
    const uint32_t cols =
        (uint32_t)(((((1ull << max(pw, 0)) - 1ull) << yy)) & wmask);
    for (int x = xx; x < min(xx + ph, H); ++x) b.grid[x] |= cols;
    // pin rotation (Component.place_component:156-204)
    for (int q = 0; q < P; ++q) {
      if (b.pcomp[q] != b.cur) continue;
      const int r0 = b.prx[q], r1 = b.pry[q];
      const int nrx = osel == 0 ? r0 : osel == 1 ? r1
                    : osel == 2 ? chc - r0 - 1 : cwc - r1 - 1;
      const int nry = osel == 0 ? r1 : osel == 1 ? chc - r0 - 1
                    : osel == 2 ? cwc - r1 - 1 : r0;
      b.prx[q] = nrx;
      b.pry[q] = nry;
      b.pax[q] = xx + nrx;
      b.pay[q] = yy + nry;
    }
    ++b.cur;
  }
  const bool placed_all = b.cur >= b.numc;
  planes_for(p, b, comp_at(b.ch, b.cur, C), comp_at(b.cw, b.cur, C),
             !placed_all);
  const int nt = plane_count(p, b.pl0) + plane_count(p, b.pl1);
  const bool done = placed_all || nt == 0 || !alive;
  if (!done) return;
  // routed reward on the post-placement tables, else the penalty
  const float reward = (placed_all && alive) ? centroid_reward(p, b)
                                             : p.penalty;
  rsum = rsum + reward;
  ++dcnt;
  generate(p, rng, b);
}

__global__ void __launch_bounds__(THREADS)
fused_rollout_kernel(FusedRolloutParams p, FusedRolloutLeaves in,
                     FusedRolloutLeaves out, float* rsum_out,
                     int32_t* dcnt_out, int batch, int num_steps, int block,
                     uint32_t seed) {
  const int bi = blockIdx.x * blockDim.x + threadIdx.x;
  if (bi >= batch) return;
  const int H = p.height, W = p.width, A = H * W, C = p.components;
  const int P = p.pins;
  const int64_t b = bi;
  Board bd;
  for (int x = 0; x < H; ++x) {
    uint32_t g = 0u, m0 = 0u, m1 = 0u;
    for (int y = 0; y < W; ++y) {
      const int64_t a = b * A + x * W + y;
      g |= (uint32_t)(in.grid[a] != 0.0f) << y;
      m0 |= (uint32_t)(in.plane0[a] != 0.0f) << y;
      m1 |= (uint32_t)(in.plane1[a] != 0.0f) << y;
    }
    bd.grid[x] = g;
    bd.pl0[x] = m0;
    bd.pl1[x] = m1;
  }
  for (int c = 0; c < C; ++c) {
    bd.ch[c] = in.comp_h[b * C + c];
    bd.cw[c] = in.comp_w[b * C + c];
  }
  bd.cur = in.cursor[b];
  bd.numc = in.num_components[b];
  bd.npin = in.num_pins[b];
  for (int q = 0; q < P; ++q) {
    bd.prx[q] = in.pin_rel_x[b * P + q];
    bd.pry[q] = in.pin_rel_y[b * P + q];
    bd.pax[q] = in.pin_abs_x[b * P + q];
    bd.pay[q] = in.pin_abs_y[b * P + q];
    bd.pnet[q] = in.pin_net[b * P + q];
    bd.pcomp[q] = in.pin_comp[b * P + q];
  }

  Rng rng;
  rng.row = (uint32_t)(bi % block);
  const uint32_t blk_salt = seed ^ ((uint32_t)(bi / block) * 0x9e3779b9u);
  float rsum = 0.0f;
  int dcnt = 0;
  for (int t = 0; t < num_steps; ++t) {
    rng.salt = mix32(blk_salt ^ ((uint32_t)t * 0x85ebca6bu));
    step(p, rng, bd, rsum, dcnt);
  }

  for (int x = 0; x < H; ++x) {
    for (int y = 0; y < W; ++y) {
      const int64_t a = b * A + x * W + y;
      out.grid[a] = (float)((bd.grid[x] >> y) & 1u);
      out.plane0[a] = (float)((bd.pl0[x] >> y) & 1u);
      out.plane1[a] = (float)((bd.pl1[x] >> y) & 1u);
    }
  }
  for (int c = 0; c < C; ++c) {
    out.comp_h[b * C + c] = bd.ch[c];
    out.comp_w[b * C + c] = bd.cw[c];
  }
  out.cursor[b] = bd.cur;
  out.num_components[b] = bd.numc;
  out.num_pins[b] = bd.npin;
  for (int q = 0; q < P; ++q) {
    out.pin_rel_x[b * P + q] = bd.prx[q];
    out.pin_rel_y[b * P + q] = bd.pry[q];
    out.pin_abs_x[b * P + q] = bd.pax[q];
    out.pin_abs_y[b * P + q] = bd.pay[q];
    out.pin_net[b * P + q] = bd.pnet[q];
    out.pin_comp[b * P + q] = bd.pcomp[q];
  }
  rsum_out[b] = rsum;
  dcnt_out[b] = dcnt;
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
  return -1;
}

// Launches the chunk on `stream` and returns cudaGetLastError() (0 = ok).
// Does not synchronise; allocates nothing.
int fused_rollout_launch(const FusedRolloutParams* params,
                         const FusedRolloutLeaves* in,
                         const FusedRolloutLeaves* out, float* rsum,
                         int32_t* dcnt, int batch, int num_steps, int block,
                         uint32_t seed, void* stream) {
  const int grid = (batch + THREADS - 1) / THREADS;
  fused_rollout_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      *params, *in, *out, rsum, dcnt, batch, num_steps, block, seed);
  return (int)cudaGetLastError();
}

}  // extern "C"

// Fused rollout chunk, one thread per board.
//
// Replaces the Pallas TPU kernel of placement_tpu/ops/fused_rollout.py
// (make_fused_rollout's pl.pallas_call, kernel body _build_kernel). The TPU
// kernel is specialised at trace time; here each specialisation is one
// instantiation of the template fused_rollout_kernel<K> (enum Kernel in
// fused_common.cuh), except K_CENTROID, which runs one warp per board
// (fused_rollout_warp.cu; fused_rollout_launch below dispatches to it):
//   K_BEAM, K_BOTH  PIN / PIN_SPATIAL with the beam or "both" routing
//       reward (placement_tpu/ops/fused_routing.py); when
//       max_num_pins_per_net > min_num_pins_per_net their generator also
//       runs the softmax-normal net allocation (extra_pins), a branch on
//       the parameters that every board of a launch takes alike;
//   K_SQUARE, K_RECT  the reduced kernels: no pin tables, +1 per placement,
//       one (SQUARE) or two (RECT) orientation planes.
// Each thread runs the whole num_steps chunk of its board: random
// legal-action sampling, placement (and pin rotation), the next legality
// planes, the done test, the reward, and on episode end the regeneration of
// a fresh instance. Specialising at compile time keeps the beam state out
// of the reduced kernels' stack frames and their 64-entry component tables
// out of the pin kernels'.
//
// What bounds it on an H100: per-board integer work and local-memory
// traffic, not device-memory bandwidth. A chunk reads and writes each
// board's ~2.4 KB of state once; everything in between is branchy scalar
// work on per-thread tables (the pin table, the allocation tables, the
// beams). At the flagship size there are only 4096 boards, so only 4096
// threads: about one warp per SM scheduler, and latency is hidden by nothing
// but each thread's own instruction-level parallelism. The beam reward adds
// divergence: in a warp, the boards that finish an episode route while the
// others wait.
//
// What the design does about it: the TPU layout ([block, F] rows, [A, A]
// cover and prefix matmuls, lane gathers) is not carried over. Occupancy
// and legality planes are 32-bit row masks, so a footprint test is a few
// ORs and shifts per row, a plane count is popcounts, and the sampled anchor
// is found by popcount and bit clearing. Random numbers are drawn only by
// boards that finish (the JAX kernel's lax.cond over the block computes the
// same per-board values), and only the cells that are used are drawn. A beam
// candidate is (parent, new pin, cost), not a copy of its parent's path:
// all beams of a board share the same unset tail, so ranking two candidates
// compares the parents' path prefixes and then the two new pins.
//
// Semantics kept bit for bit with the JAX kernel: the counter-hash PRNG
// (_mix/_Rng) with the LOGICAL block of make_fused_rollout's `block`
// argument in the salt, the draw order (call 1 in the step; 2..7+N in the
// pin generator, 2..10+N with extra pins per net, 2..4 in RECT's, none in
// SQUARE's), stable sorts, in-order water-fills, true f32 division in the
// allocation and the beam's centroid, first-wins ties, and the f32 operation
// order of the routing rewards. Build with -fmad=false and without
// --use_fast_math so no FMA contraction or approximate division or sqrt
// changes a rounding. The net allocation's log, cos, exp and sqrt are taken
// in f64 and rounded to f32, as the plain version takes them: f32 libraries
// (XLA's, PyTorch's, CUDA's) do not round them correctly.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "fused_common.cuh"

namespace {

constexpr int THREADS = 128;

struct Masks {
  uint32_t grid[MAX_H];            // bit y of row x = cell x*W + y occupied
  uint32_t pl0[MAX_H], pl1[MAX_H]; // legality planes, same layout
};

// A board of the pin kernels.
struct Board : Masks {
  int32_t ch[MAX_C], cw[MAX_C];
  int32_t cur, numc, npin;
  int32_t prx[MAX_P], pry[MAX_P], pax[MAX_P], pay[MAX_P];
  int32_t pnet[MAX_P], pcomp[MAX_P];
};

// A board of the reduced kernels: no pin tables. Its pin leaves pass
// through unchanged until the board is regenerated (`fresh`), which writes
// them as -1 with num_pins = 0.
struct NopinBoard : Masks {
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
__device__ void planes_for(const FusedRolloutParams& p, Masks& b, int ch_c,
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

// ---- centroid routing reward (fused_routing.centroid_wl_int) -------------

// Centroid-route wirelength and crossing count of the board's pin tables.
__device__ void centroid_wl_int(const FusedRolloutParams& p, const Board& b,
                                float& wl_out, int& ints_out) {
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
  wl_out = wl;
  ints_out = ints;
}

// ---- beam-search routing reward (fused_routing.beam_wl_int) ---------------

constexpr float BIG = 1e9f;       // dead-path cost, routing.BIG
constexpr float INF2 = 2e9f;      // "already selected" marker
constexpr float COORD_BASE = 32768.0f;

struct Beam {
  float cost;
  uint32_t vis;           // visited lanes (and lanes without a pin)
  uint8_t path[MAX_M];    // lane of the pin at each path position
};

struct Cand {
  float cost;
  uint8_t parent, lane;
};

// A net's pins by rank: x, y of the j-th pin as f32, 0 where there is none;
// `cnt` pins, of which the first `lim` = min(cnt, M) have a lane.
struct Net {
  float x[MAX_M], y[MAX_M];
  int cnt, lim;
  __device__ float key(int j) const { return x[j] * COORD_BASE + y[j]; }
};

// Heap order of two candidates of round `step` (routing._heap_order):
// cost, then the path keys from position 0. A candidate's path is its
// parent's up to `step`, its new pin at step + 1, unset (-1) beyond, and
// every beam of a board has the same unset tail. Strict: equal candidates
// compare false, so the scan order supplies lexsort's stability.
__device__ __forceinline__ bool cand_less(const Net& net, const Beam* beams,
                                          const Cand& a, const Cand& b,
                                          int step) {
  if (a.cost != b.cost) return a.cost < b.cost;
  const uint8_t* pa = beams[a.parent].path;
  const uint8_t* pb = beams[b.parent].path;
  for (int t = 0; t <= step; ++t) {
    const float ka = net.key(pa[t]), kb = net.key(pb[t]);
    if (ka != kb) return ka < kb;
  }
  return net.key(a.lane) < net.key(b.lane);
}

// Beam search over one net (fused_routing._beam_net); writes the lanes of
// the best path's first max(lim, 1) positions to `route`.
__device__ void beam_net(const Net& net, int M, int bw, uint8_t* route) {
  const int lim = net.lim;
  // start = the pin farthest from the net centroid, first max wins; a net
  // without pins starts at lane 0 (every distance is -1)
  float sx = 0.f, sy = 0.f;
  for (int j = 0; j < lim; ++j) {
    sx += net.x[j];
    sy += net.y[j];
  }
  const float denom = (float)max(net.cnt, 1);
  const float cx = sx / denom, cy = sy / denom;
  int start = 0;
  float dmax = -2.f;
  for (int j = 0; j < M; ++j) {
    float d0 = -1.f;
    if (j < lim) {
      const float dx = net.x[j] - cx, dy = net.y[j] - cy;
      d0 = sqrtf(dx * dx + dy * dy);
    }
    if (d0 > dmax) {
      dmax = d0;
      start = j;
    }
  }

  Beam buf[2][MAX_BW];
  Beam* beams = buf[0];
  Beam* next = buf[1];
  const uint32_t lanes = M >= 32 ? 0xffffffffu : ((1u << M) - 1u);
  const uint32_t absent = lanes & ~((1u << lim) - 1u);
  for (int k = 0; k < bw; ++k) {
    beams[k].cost = k == 0 ? 0.f : BIG;
    beams[k].vis = (1u << start) | absent;
    beams[k].path[0] = (uint8_t)start;
  }

  // rounds until the board freezes: lim - 1 expansions
  for (int step = 0; step + 1 <= lim - 1; ++step) {
    // candidates: parent-major, nearest-neighbour-minor
    Cand cand[MAX_BW * MAX_BW];
    for (int k = 0; k < bw; ++k) {
      const int cur = beams[k].path[step];
      const float curx = net.x[cur], cury = net.y[cur];
      float d[MAX_M];
      for (int j = 0; j < M; ++j) {
        const float dx = net.x[j] - curx, dy = net.y[j] - cury;
        d[j] = (beams[k].vis >> j) & 1u ? BIG : sqrtf(dx * dx + dy * dy);
      }
      uint32_t taken = 0u;
      for (int c = 0; c < bw; ++c) {
        // nearest lane not taken yet, first wins; when only visited lanes
        // are left it is the first of them (m == BIG), and when every lane
        // is taken it is lane 0 (m == INF2)
        float m = INF2;
        int jj = -1;
        for (int j = 0; j < M; ++j) {
          const float eff = (taken >> j) & 1u ? INF2 : d[j];
          if (jj < 0 || eff < m) {
            m = eff;
            jj = j;
          }
        }
        taken |= 1u << jj;
        float ccost = beams[k].cost + (m >= INF2 ? BIG : m);
        ccost = ccost >= BIG ? BIG : ccost;
        cand[k * bw + c] = Cand{ccost, (uint8_t)k, (uint8_t)jj};
      }
    }
    // keep the bw best candidates in heap order, first wins on ties
    uint32_t ctaken = 0u;
    for (int k = 0; k < bw; ++k) {
      int sel = -1;
      for (int i = 0; i < bw * bw; ++i) {
        if ((ctaken >> i) & 1u) continue;
        if (sel < 0 || cand_less(net, beams, cand[i], cand[sel], step))
          sel = i;
      }
      ctaken |= 1u << sel;
      const Beam& par = beams[cand[sel].parent];
      Beam& nb = next[k];
      nb.cost = cand[sel].cost;
      nb.vis = par.vis | (1u << cand[sel].lane);
      for (int t = 0; t <= step; ++t) nb.path[t] = par.path[t];
      nb.path[step + 1] = cand[sel].lane;
    }
    Beam* tmp = beams;
    beams = next;
    next = tmp;
  }

  // final heap pop: min (cost, path keys), first wins
  const int len = max(lim, 1);
  int best = 0;
  for (int k = 1; k < bw; ++k) {
    bool better = beams[k].cost < beams[best].cost;
    if (beams[k].cost == beams[best].cost) {
      for (int t = 0; t < len; ++t) {
        const float ka = net.key(beams[k].path[t]);
        const float kb = net.key(beams[best].path[t]);
        if (ka != kb) {
          better = ka < kb;
          break;
        }
      }
    }
    if (better) best = k;
  }
  for (int t = 0; t < len; ++t) route[t] = beams[best].path[t];
}

// Beam-route wirelength and crossing count (fused_routing.beam_wl_int):
// every net routed from its outlier pin, cnt - 1 segments per net; the
// wirelength is added nets outer, positions inner, as the JAX module adds
// it.
__device__ void beam_wl_int(const FusedRolloutParams& p, const Board& b,
                            float& wl_out, int& ints_out) {
  const int N = p.nets, M = p.pins_per_net, P = p.pins;
  int8_t rx[MAX_N][MAX_M], ry[MAX_N][MAX_M];
  int lim[MAX_N];
  float wl = 0.f;
  int start = 0;
  for (int n = 0; n < N; ++n) {
    Net net;
    net.cnt = 0;
    for (int j = 0; j < M; ++j) net.x[j] = net.y[j] = 0.f;
    for (int q = 0; q < P; ++q) {
      if (q >= b.npin || b.pnet[q] != n) continue;
      ++net.cnt;
      const int j = q - start;
      if (j >= 0 && j < M) {
        net.x[j] = (float)b.pax[q];
        net.y[j] = (float)b.pay[q];
      }
    }
    start += net.cnt;
    net.lim = min(net.cnt, M);
    lim[n] = net.lim;
    uint8_t route[MAX_M];
    beam_net(net, M, p.beam_width, route);
    for (int t = 0; t < max(net.lim, 1); ++t) {
      rx[n][t] = (int8_t)net.x[route[t]];
      ry[n][t] = (int8_t)net.y[route[t]];
    }
    for (int t = 0; t + 1 <= net.lim - 1; ++t) {
      const float dx = (float)rx[n][t] - (float)rx[n][t + 1];
      const float dy = (float)ry[n][t] - (float)ry[n][t + 1];
      wl += sqrtf(dx * dx + dy * dy);
    }
  }
  int ints = 0;
  for (int n1 = 0; n1 < N; ++n1)
    for (int n2 = n1 + 1; n2 < N; ++n2)
      for (int t1 = 0; t1 + 1 <= lim[n1] - 1; ++t1)
        for (int t2 = 0; t2 + 1 <= lim[n2] - 1; ++t2)
          ints += seg_intersect(rx[n1][t1], ry[n1][t1], rx[n1][t1 + 1],
                                ry[n1][t1 + 1], rx[n2][t2], ry[n2][t2],
                                rx[n2][t2 + 1], ry[n2][t2 + 1]);
  wl_out = wl;
  ints_out = ints;
}

// The routed terminal reward of the kernel's reward type (reward_rows);
// "both" takes the route with fewer crossings, a tie goes to beam. The
// centroid reward alone is fused_rollout_warp.cu's.
template <int K>
__device__ float routed_reward(const FusedRolloutParams& p, const Board& b) {
  static_assert(K == K_BEAM || K == K_BOTH, "beam or both only");
  float wl = 0.f, c_wl = 0.f;
  int ints = 0, c_ints = 0;
  if (K == K_BOTH) centroid_wl_int(p, b, c_wl, c_ints);
  beam_wl_int(p, b, wl, ints);
  if (K == K_BOTH && ints > c_ints) {
    wl = c_wl;
    ints = c_ints;
  }
  return -(p.lam_w * (wl / p.wl_norm) + p.lam_i * ((float)ints / p.int_norm));
}

// ---- in-kernel instance generator (generate) -----------------------------

// One net's pin -> component allocation, drawing call `call`; writes the
// component of each of the net's M ranks to `comp_of` and updates `space`
// when the net is open.
__device__ void allocate_net(const FusedRolloutParams& p, const Rng& rng,
                             uint32_t call, int m, int k0, bool open,
                             int* space, int* comp_of) {
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
    const float ut = rng.uniform(call, M, j);
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

// Adds to `net_count` the extra pins of each open net when max_ppn > min_ppn
// (generate :407-450, allocate_pins_to_nets:1067): weights softmax(N(1/nn,
// 1/(net_distribution + 1))) from N Box-Muller normals (draws 7 and 8), a
// multinomial of the `extra_total` extra pins (draw 9, T = (max_ppn -
// min_ppn) * N uniforms, each binned as it is drawn) capped at max_ppn -
// min_ppn per net, then an in-order water-fill of the residue.
__device__ void extra_pins(const FusedRolloutParams& p, const Rng& rng, int nn,
                           int extra_total, int* net_count) {
  const int N = p.nets, span = p.max_ppn - p.ppn, T = span * N;
  float s[MAX_N];
  float smax = -1e9f;
  for (int n = 0; n < N; ++n) {
    const float u1 = fmaxf(rng.uniform(7, N, n), 1e-7f);
    const float u2 = rng.uniform(8, N, n);
    const float r = (float)sqrt((double)(-2.0f * (float)log((double)u1)));
    const float z = r * (float)cos((double)(6.2831853f * u2));
    const float mean = 1.0f / (float)max(nn, 1);
    s[n] = n < nn ? mean + z / p.net_div : -1e9f;
    smax = fmaxf(smax, s[n]);
  }
  float e[MAX_N];
  float tot = 0.f;
  for (int n = 0; n < N; ++n) {
    e[n] = (float)exp((double)(s[n] - smax));
    tot += e[n];
  }
  float cprob[MAX_N];
  float acc = 0.f;
  for (int n = 0; n < N; ++n) cprob[n] = acc += e[n] / tot;
  int cnt[MAX_N];
  for (int n = 0; n < N; ++n) cnt[n] = 0;
  for (int j = 0; j < min(extra_total, T); ++j) {
    const float ut = rng.uniform(9, T, j);
    int bin = 0;
    for (int c = 0; c < N - 1; ++c) bin += ut > cprob[c];
    ++cnt[bin];
  }
  const int cap = min(span, extra_total);
  int got = 0;
  for (int n = 0; n < N; ++n) {
    cnt[n] = min(cnt[n], n < nn ? cap : 0);
    got += cnt[n];
  }
  const int resid = extra_total - got;
  int before = 0;
  for (int n = 0; n < N; ++n) {
    const int free_n = (n < nn ? cap : 0) - cnt[n];
    net_count[n] += cnt[n] + min(max(resid - before, 0), free_n);
    before += free_n;
  }
}

// The pin kernels' generator (generate, :363-601).
template <int K>
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
  // draw 5: net count; draw 6: total pin count, which feeds only the
  // max_ppn > min_ppn allocation (draws 7, 8, 9)
  int nn = randint(p.min_n, p.max_n, rng.uniform(5, 1, 0));
  nn = max(min(nn, total_area / 2), 1);
  int net_count[MAX_N];
  for (int n = 0; n < N; ++n) net_count[n] = n < nn ? p.ppn : 0;
  // first call of the per-net allocations: after draw 6, or after draw 9
  uint32_t call_base = 7;
  if (p.max_ppn > p.ppn) {
    const int tp = min(
        randint(p.ppn * nn, p.max_ppn * nn, rng.uniform(6, 1, 0)),
        total_area);
    extra_pins(p, rng, nn, max(tp - p.ppn * nn, 0), net_count);
    call_base = 10;
  }
  int ncum[MAX_N];
  int num_pins = 0;
  for (int n = 0; n < N; ++n) ncum[n] = num_pins += net_count[n];
  b.npin = num_pins;

  int k0 = p.spatial ? (p.pin_spread * b.numc) / 10 + 1
                     : max(((p.pin_spread + 1) * b.numc) / 10, 1);
  k0 = min(k0, b.numc);
  int table[MAX_N * MAX_M];
  for (int n = 0; n < N; ++n)  // draws call_base .. call_base+N-1
    allocate_net(p, rng, call_base + n, net_count[n], k0, n < nn, space,
                 table + n * M);

  // draw call_base+N: a random cell order per component, stable ascending
  // sort of uniform scores with unused cells scored 2.0
  int cell_table[MAX_C * MAX_PPC];
  for (int c = 0; c < C; ++c) {
    float sc[MAX_PPC];
    int* perm = cell_table + c * PPC;
    for (int k = 0; k < PPC; ++k) {
      const float v = k < area[c]
                          ? rng.uniform(call_base + N, C * PPC, c * PPC + k)
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
  planes_for<K>(p, b, b.ch[0], b.cw[0], true);
}

// The reduced kernels' generator (generate, :364-397): SQUARE's unlimited
// supply of n x n components draws nothing; RECT draws heights (call 2),
// widths (call 3) and the count (call 4).
template <int K>
__device__ void generate_nopin(const FusedRolloutParams& p, const Rng& rng,
                               NopinBoard& b) {
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
// (:610-643). PIN draws over four planes (2 and 3 copy 0 and 1), RECT over
// two, SQUARE over one. Returns whether any action was legal.
template <int K>
__device__ __forceinline__ bool sample_action(const FusedRolloutParams& p,
                                              const Rng& rng, const Masks& b,
                                              int& osel, int& idx) {
  const int c0 = plane_count(p, b.pl0);
  const int c1 = K == K_SQUARE ? 0 : plane_count(p, b.pl1);
  const float total = K == K_SQUARE ? (float)c0
                    : K == K_RECT   ? (float)(c0 + c1)
                                    : 2.0f * (float)(c0 + c1);
  const float u = rng.uniform(1, 1, 0);
  float tgt = fminf(floorf(u * total), total - 1.0f);
  tgt = fmaxf(tgt, 0.0f);
  const float pre1 = (float)c0;
  float tin = tgt;
  osel = 0;
  if (K == K_RECT) {
    osel = tgt >= pre1;
    tin = tgt - (osel == 0 ? 0.0f : pre1);
  } else if (K != K_SQUARE) {
    const float pre2 = (float)(c0 + c1);
    const float pre3 = pre2 + (float)c0;
    osel = (tgt >= pre1) + (tgt >= pre2) + (tgt >= pre3);
    tin = tgt - (osel == 0   ? 0.0f
                 : osel == 1 ? pre1
                 : osel == 2 ? pre2
                             : pre3);
  }
  idx = nth_cell(p, osel % 2 == 0 ? b.pl0 : b.pl1, (int)tin);
  return total > 0.0f;
}

// Marks the (ph, pw) footprint anchored at cell idx as occupied.
__device__ __forceinline__ void paint(const FusedRolloutParams& p, Masks& b,
                                      int idx, int ph, int pw) {
  const int H = p.height, W = p.width;
  const int xx = idx / W, yy = idx % W;
  const uint64_t wmask = (1ull << W) - 1ull;
  const uint32_t cols =
      (uint32_t)(((((1ull << max(pw, 0)) - 1ull) << yy)) & wmask);
  for (int x = xx; x < min(xx + ph, H); ++x) b.grid[x] |= cols;
}

template <int K>
__device__ void step(const FusedRolloutParams& p, const Rng& rng, Board& b,
                     float& rsum, int& dcnt) {
  const int W = p.width, C = p.components, P = p.pins;
  int osel, idx;
  const bool alive = sample_action<K>(p, rng, b, osel, idx);
  const int xx = idx / W, yy = idx % W;
  const bool even = osel % 2 == 0;

  const int chc = comp_at(b.ch, b.cur, C), cwc = comp_at(b.cw, b.cur, C);
  if (alive) {
    paint(p, b, idx, even ? chc : cwc, even ? cwc : chc);
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
  planes_for<K>(p, b, comp_at(b.ch, b.cur, C), comp_at(b.cw, b.cur, C),
                !placed_all);
  const int nt = plane_count(p, b.pl0) + plane_count(p, b.pl1);
  const bool done = placed_all || nt == 0 || !alive;
  if (!done) return;
  // routed reward on the post-placement tables, else the penalty
  const float reward = (placed_all && alive) ? routed_reward<K>(p, b)
                                             : p.penalty;
  rsum = rsum + reward;
  ++dcnt;
  generate<K>(p, rng, b);
}

// The reduced kernels' step: +1 per successful placement, terminal or not
// (:711-713), no pins to rotate.
template <int K>
__device__ void step_nopin(const FusedRolloutParams& p, const Rng& rng,
                           NopinBoard& b, float& rsum, int& dcnt) {
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
  generate_nopin<K>(p, rng, b);
}

// ---- the kernel ------------------------------------------------------------

__device__ void load_masks(const FusedRolloutParams& p,
                           const FusedRolloutLeaves& in, int64_t b,
                           Masks& m) {
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
                            const Masks& m) {
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
  constexpr bool kPins = K != K_SQUARE && K != K_RECT;
  using BoardT = typename std::conditional<kPins, Board, NopinBoard>::type;
  const int bi = blockIdx.x * blockDim.x + threadIdx.x;
  if (bi >= batch) return;
  const int C = p.components, P = p.pins;
  const int64_t b = bi;
  BoardT bd;
  load_masks(p, in, b, bd);
  for (int c = 0; c < C; ++c) {
    bd.ch[c] = in.comp_h[b * C + c];
    bd.cw[c] = in.comp_w[b * C + c];
  }
  bd.cur = in.cursor[b];
  bd.numc = in.num_components[b];
  if constexpr (kPins) {
    bd.npin = in.num_pins[b];
    for (int q = 0; q < P; ++q) {
      bd.prx[q] = in.pin_rel_x[b * P + q];
      bd.pry[q] = in.pin_rel_y[b * P + q];
      bd.pax[q] = in.pin_abs_x[b * P + q];
      bd.pay[q] = in.pin_abs_y[b * P + q];
      bd.pnet[q] = in.pin_net[b * P + q];
      bd.pcomp[q] = in.pin_comp[b * P + q];
    }
  } else {
    bd.fresh = false;
  }

  Rng rng;
  rng.row = (uint32_t)(bi % block);
  const uint32_t blk_salt = block_salt(bi, block, seed);
  float rsum = 0.0f;
  int dcnt = 0;
  for (int t = 0; t < num_steps; ++t) {
    rng.salt = step_salt(blk_salt, t);
    if constexpr (kPins)
      step<K>(p, rng, bd, rsum, dcnt);
    else
      step_nopin<K>(p, rng, bd, rsum, dcnt);
  }

  store_masks(p, out, b, bd);
  for (int c = 0; c < C; ++c) {
    out.comp_h[b * C + c] = bd.ch[c];
    out.comp_w[b * C + c] = bd.cw[c];
  }
  out.cursor[b] = bd.cur;
  out.num_components[b] = bd.numc;
  if constexpr (kPins) {
    out.num_pins[b] = bd.npin;
    for (int q = 0; q < P; ++q) {
      out.pin_rel_x[b * P + q] = bd.prx[q];
      out.pin_rel_y[b * P + q] = bd.pry[q];
      out.pin_abs_x[b * P + q] = bd.pax[q];
      out.pin_abs_y[b * P + q] = bd.pay[q];
      out.pin_net[b * P + q] = bd.pnet[q];
      out.pin_comp[b * P + q] = bd.pcomp[q];
    }
  } else {
    // the pin leaves pass through; a regenerated board has none
    out.num_pins[b] = bd.fresh ? 0 : in.num_pins[b];
    int32_t* const outs[6] = {out.pin_rel_x, out.pin_rel_y, out.pin_abs_x,
                              out.pin_abs_y, out.pin_net,   out.pin_comp};
    const int32_t* const ins[6] = {in.pin_rel_x, in.pin_rel_y, in.pin_abs_x,
                                   in.pin_abs_y, in.pin_net,   in.pin_comp};
    for (int l = 0; l < 6; ++l)
      for (int q = 0; q < P; ++q)
        outs[l][b * P + q] = bd.fresh ? -1 : ins[l][b * P + q];
  }
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
    case K_CENTROID:  // one warp per board, fused_rollout_warp.cu
      return fused_rollout_warp_launch(*params, *in, *out, rsum, dcnt,
                                       batch, num_steps, block, seed, st);
    case K_BEAM:
      launch<K_BEAM>(*params, *in, *out, rsum, dcnt, batch, num_steps, block,
                     seed, st);
      break;
    case K_BOTH:
      launch<K_BOTH>(*params, *in, *out, rsum, dcnt, batch, num_steps, block,
                     seed, st);
      break;
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

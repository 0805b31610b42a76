// Fused rollout chunk, K_CENTROID: one warp per board, the board's state in
// registers spread over the warp's lanes.
//
// Replaces the Pallas TPU kernel of placement_tpu/ops/fused_rollout.py
// (make_fused_rollout's pl.pallas_call at :866, body _build_kernel
// :290-763) for PIN / PIN_SPATIAL with the centroid routing reward
// (placement_tpu/ops/fused_routing.py::centroid_wl_int :85-173, through
// reward_rows :406-430), with fixed or varying pins per net. It computes
// exactly what the one-thread-per-board template of fused_rollout.cu
// computes, bit for bit; the other four specialisations stay there.
//
// What bounds it on an H100: scalar operations, not bytes. A board-step of
// the flagship (10x10 grid, 5 components, 3 nets x 6 pins) is ~450 integer
// operations (sampling, paint, pin rotation, two legality planes); an
// episode (one step in five) adds ~4.2k for the centroid reward (108
// segment pairs on different nets at ~35 operations each, plus the
// per-pin terms) and ~1.3k for the generator: ~1.5k operations per
// board-step, ~3.2e8 per 50-step chunk of 4096 boards. Their integer half
// (~1.6e8) at the card's integer issue rate takes ~9.7 us and binds
// (chip_smoke.py's _chunk_bound). The leaves are ~1.7 KB per board, read
// and written once: ~14 MB, ~4 us at 3.35 TB/s.
//
// What the design does about it. The per-thread kernel kept each board in
// a 3840 B stack frame indexed dynamically; 128 such frames per SM overflow
// L1, so its serial chain of a few thousand instructions per board-step ran
// at tens of cycles each from L2. Here:
//   * a board is a warp: lane x holds grid row x and the two legality-plane
//     rows (MAX_H = 32), lane q holds pins q and q + 32 (MAX_P <= 64),
//     lane c component c; cursor, component and pin counts are uniform.
//     Only the two tables read at computed indices live in shared memory,
//     a slice per warp: the per-net allocation table and the cell order;
//   * the loops over rows, pins, components and nets run across the lanes
//     (shuffles, ballots, warp sums, __match_any_sync), so the serial chain
//     of a board-step is tens of warp instructions, not thousands;
//   * 8 boards per 256-thread block, at most 64 registers a thread: all of
//     4096 boards (31 warps per SM on 132 SMs) are resident at once.
// Every f32 sum whose order the plain version fixes is still taken in that
// order (the wirelength over pins, the allocation's weights, the softmax
// total and cumulative probabilities, the per-board reward sum): lane 0's
// order, broadcast. Integer sums (and f32 sums of small integers, exact in
// any order) are warp reductions. Every sort is a rank by counting over
// unique keys, which gives the stable sort's order. The PRNG row and salt
// are those of the LOGICAL block, whatever the launch geometry. Build with
// -fmad=false, IEEE division and sqrt; the allocation's log, cos, exp and
// sqrt are taken in f64 and rounded to f32, as in the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;                 // boards per block
constexpr int BLOCK_THREADS = 32 * WARPS;
constexpr int MIN_BLOCKS = 4;            // 64 registers a thread

static_assert(MAX_H <= 32, "a grid row per lane");
static_assert(MAX_P <= 64, "two pin slots per lane");
static_assert(MAX_C <= 32 && MAX_N <= 32 && MAX_M <= 32, "a lane per entry");
static_assert(MAX_PPC <= 16, "two components' cells per warp pass");

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

// A board: lane x's grid and plane rows, lane c's component, lane q's pins
// q (slot 0) and q + 32 (slot 1).
struct WarpBoard {
  uint32_t grid, pl0, pl1;
  int32_t ch, cw;
  int32_t prx[2], pry[2], pax[2], pay[2], pnet[2], pcomp[2];
  int32_t cur, numc, npin;  // uniform
};

// t[min(i, C-1)] of a lane-held table, 0 for i < 0 (uniform i).
__device__ __forceinline__ int comp_at(int v, int i, int C) {
  i = min(i, C - 1);
  const int got = __shfl_sync(FULL, v, max(i, 0));
  return i >= 0 ? got : 0;
}

// ---- legality planes ------------------------------------------------------

__device__ __forceinline__ bool in_footprints(const FusedRolloutParams& p,
                                              int h, int w) {
  return (h >= p.min_h && h <= p.max_h && w >= p.min_w && w <= p.max_w) ||
         (w >= p.min_h && w <= p.max_h && h >= p.min_w && h <= p.max_w);
}

// Row `lane` of the anchors where an (ph, pw) footprint is in bounds and
// covers no occupied cell; 0 for a footprint outside the config's set.
__device__ uint32_t free_row(const FusedRolloutParams& p, uint32_t grid,
                             int ph, int pw, int lane) {
  const int H = p.height, W = p.width;
  const bool known = in_footprints(p, ph, pw) && pw <= W;
  if (!known) return 0u;
  const int nanchor = W - pw + 1;
  const uint32_t anchors =
      nanchor >= 32 ? FULL : ((1u << max(nanchor, 0)) - 1u);
  uint32_t occ = 0u;
  for (int dx = 0; dx < ph; ++dx) occ |= __shfl_down_sync(FULL, grid, dx);
  uint32_t dil = 0u;
  for (int dy = 0; dy < pw; ++dy) dil |= occ >> dy;
  return (lane < H && lane + ph <= H) ? (~dil & anchors) : 0u;
}

__device__ __forceinline__ void planes_for(const FusedRolloutParams& p,
                                           WarpBoard& b, int ch_c, int cw_c,
                                           bool alive, int lane) {
  if (!alive) {
    b.pl0 = b.pl1 = 0u;
    return;
  }
  b.pl0 = free_row(p, b.grid, ch_c, cw_c, lane);
  b.pl1 = free_row(p, b.grid, cw_c, ch_c, lane);
}

__device__ __forceinline__ int plane_count(uint32_t pl) {
  return warp_sum(__popc(pl));
}

// Row-major index of the k-th (0-based) legal cell, H*W-1 if there is none:
// the row is the first lane whose running count passes k, the column the
// remaining rank's set bit of that row.
__device__ int nth_cell(const FusedRolloutParams& p, uint32_t pl, int k,
                        int lane) {
  const int incl = warp_scan(__popc(pl), lane, 32);
  const uint32_t past = __ballot_sync(FULL, incl > k);
  if (past == 0u) return p.height * p.width - 1;
  const int x = __ffs(past) - 1;
  const uint32_t m = __shfl_sync(FULL, pl, x);
  const int kk = k - (__shfl_sync(FULL, incl, x) - __popc(m));
  const uint32_t below = (1u << lane) - 1u;
  const uint32_t hit =
      __ballot_sync(FULL, ((m >> lane) & 1u) && __popc(m & below) == kk);
  return x * p.width + (__ffs(hit) - 1);
}

// ---- centroid routing reward (fused_routing.centroid_wl_int) -------------

// Centroid-route wirelength and crossing count of the board's pins (the
// same on every lane).
__device__ void centroid_wl_int(const FusedRolloutParams& p,
                                const WarpBoard& b, int lane, float& wl_out,
                                int& ints_out) {
  const int N = p.nets, P = p.pins;
  // a pin's net, or -1 where it is not routed
  int net_on[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int q = lane + 32 * s, n = b.pnet[s];
    net_on[s] = (q < P && q < b.npin && n >= 0 && n < N) ? n : -1;
  }
  // lane n: net n's pin count and coordinate sums (small integers: exact
  // in f32 in any order), centroid, first pin
  int cnt = 0, sxi = 0, syi = 0;
  for (int n = 0; n < N; ++n) {
    int c = 0, x = 0, y = 0;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (net_on[s] == n) {
        ++c;
        x += b.pax[s];
        y += b.pay[s];
      }
    }
    c = warp_sum(c);
    x = warp_sum(x);
    y = warp_sum(y);
    if (lane == n) {
      cnt = c;
      sxi = x;
      syi = y;
    }
  }
  const float sx = (float)sxi, sy = (float)syi;
  const float denom = (float)max(cnt, 1);
  const float cx = sx / denom, cy = sy / denom;
  const int start = warp_scan(cnt, lane, N) - cnt;
  // lane n: the net's second pin (2-pin routes), pin start + 1
  float x2 = 0.f, y2 = 0.f;
  {
    const int s2 = start + 1, src = s2 & 31;
    const int n0 = __shfl_sync(FULL, net_on[0], src);
    const int n1 = __shfl_sync(FULL, net_on[1], src);
    const int ax0 = __shfl_sync(FULL, b.pax[0], src);
    const int ax1 = __shfl_sync(FULL, b.pax[1], src);
    const int ay0 = __shfl_sync(FULL, b.pay[0], src);
    const int ay1 = __shfl_sync(FULL, b.pay[1], src);
    const bool hi = s2 >= 32;
    if (lane < N && s2 < 64 && (hi ? n1 : n0) == lane) {
      x2 = (float)(hi ? ax1 : ax0);
      y2 = (float)(hi ? ay1 : ay0);
    }
  }
  // per-pin segments: integer-scaled endpoints for the exact predicate
  float x1s[2], y1s[2], x2s[2], y2s[2], sc[2], term[2];
  bool sv[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int q = lane + 32 * s, n = net_on[s], src = max(n, 0);
    const int c_n = __shfl_sync(FULL, cnt, src);
    const int st_n = __shfl_sync(FULL, start, src);
    const float cx_n = __shfl_sync(FULL, cx, src);
    const float cy_n = __shfl_sync(FULL, cy, src);
    const float sx_n = __shfl_sync(FULL, sx, src);
    const float sy_n = __shfl_sync(FULL, sy, src);
    const float x2_n = __shfl_sync(FULL, x2, src);
    const float y2_n = __shfl_sync(FULL, y2, src);
    const float x = (float)b.pax[s], y = (float)b.pay[s];
    float ex = 0.f, ey = 0.f, exs = 0.f, eys = 0.f, scv = 1.f;
    bool valid = false;
    if (n >= 0) {
      const bool two = c_n == 2;
      ex = two ? x2_n : cx_n;
      ey = two ? y2_n : cy_n;
      exs = two ? x2_n : sx_n;
      eys = two ? y2_n : sy_n;
      scv = two ? 1.f : (float)max(c_n, 1);
      valid = !two || q - st_n == 0;
    }
    const float dx = x - ex, dy = y - ey;
    term[s] = valid ? sqrtf(dx * dx + dy * dy) : 0.f;
    x1s[s] = x * scv;
    y1s[s] = y * scv;
    x2s[s] = exs;
    y2s[s] = eys;
    sc[s] = scv;
    sv[s] = valid;
  }
  // the wirelength in pin order (adding +0 for a pin without a term is
  // exact: the sum is never -0)
  float wl = 0.f;
  for (int q = 0; q < P; ++q)
    wl += __shfl_sync(FULL, q < 32 ? term[0] : term[1], q & 31);
  // crossings: pin q broadcast, pins r > q on their own lanes
  int ints = 0;
  for (int q = 0; q + 1 < P; ++q) {
    const bool hs = q >= 32;
    const int src = q & 31;
    const int sv_q = __shfl_sync(FULL, (int)(hs ? sv[1] : sv[0]), src);
    if (!sv_q) continue;
    const int net_q = __shfl_sync(FULL, hs ? net_on[1] : net_on[0], src);
    const float ax1 = __shfl_sync(FULL, hs ? x1s[1] : x1s[0], src);
    const float ay1 = __shfl_sync(FULL, hs ? y1s[1] : y1s[0], src);
    const float ax2 = __shfl_sync(FULL, hs ? x2s[1] : x2s[0], src);
    const float ay2 = __shfl_sync(FULL, hs ? y2s[1] : y2s[0], src);
    const float s_q = __shfl_sync(FULL, hs ? sc[1] : sc[0], src);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int r = lane + 32 * s;
      if (r > q && sv[s] && net_on[s] != net_q)
        ints += seg_intersect(ax1 * sc[s], ay1 * sc[s], ax2 * sc[s],
                              ay2 * sc[s], x1s[s] * s_q, y1s[s] * s_q,
                              x2s[s] * s_q, y2s[s] * s_q);
    }
  }
  wl_out = wl;
  ints_out = warp_sum(ints);
}

__device__ __forceinline__ float routed_reward(const FusedRolloutParams& p,
                                               const WarpBoard& b,
                                               int lane) {
  float wl;
  int ints;
  centroid_wl_int(p, b, lane, wl, ints);
  return -(p.lam_w * (wl / p.wl_norm) + p.lam_i * ((float)ints / p.int_norm));
}

// ---- in-kernel instance generator (generate) -----------------------------

// One net's pin -> component allocation, drawing call `call`: writes the
// component of each of the net's M ranks to comp_of[0..M) and, when the net
// is open, updates `space` (lane c: component c's free cells).
__device__ void allocate_net(const FusedRolloutParams& p, const Rng& rng,
                             uint32_t call, int m, int k0, bool open,
                             int& space, int* comp_of, int lane) {
  const int C = p.components, M = p.pins_per_net;
  const bool cl = lane < C;
  // components by free space, descending: the keys space*(C+1)+(C-1-i)
  // are unique, so a component's position is the count of greater keys
  const int key = space * (C + 1) + (C - 1 - lane);
  int pos = 0;
  for (int j = 0; j < C; ++j) pos += __shfl_sync(FULL, key, j) > key;
  int sidx = 0;  // lane c: the component at position c
  for (int i = 0; i < C; ++i)
    if (__shfl_sync(FULL, pos, i) == lane) sidx = i;
  const int got_space = __shfl_sync(FULL, space, sidx);
  const int s_space = cl ? got_space : 0;
  const int csum = warp_scan(s_space, lane, C);
  const int not_enough = __popc(__ballot_sync(FULL, cl && csum < m));
  const int k = max(k0, min(not_enough + 1, C));
  // cumulative f32 weights in position order
  float tot_w = 0.f, cw_cum = 0.f;
  for (int c = 0; c < C; ++c) {
    const int sc = __shfl_sync(FULL, s_space, c);
    tot_w += c < k ? (float)sc : 0.f;
    if (lane == c) cw_cum = tot_w;
  }
  tot_w = fmaxf(tot_w, 1e-9f);
  // lane j < m: rank j's uniform and its bin; bins counted by ballot
  const float ut = rng.uniform(call, M, lane);
  int bin = 0;
  for (int c = 0; c < C - 1; ++c)
    bin += ut > __shfl_sync(FULL, cw_cum, c) / tot_w;
  int cnt = 0;
  for (int c = 0; c < C; ++c) {
    const int got = __popc(__ballot_sync(FULL, lane < m && bin == c));
    if (lane == c) cnt = got;
  }
  cnt = min(cnt, s_space);
  // in-order water-fill of the residue into the remaining space
  const int resid = m - warp_sum(cnt);
  const int free_c = s_space - cnt;
  const int before = warp_scan(free_c, lane, C) - free_c;
  cnt += min(max(resid - before, 0), free_c);
  const int bound = warp_scan(cnt, lane, C);
  int slot = 0;  // lane j < M: the position that takes rank j
  for (int c = 0; c < C; ++c) slot += lane >= __shfl_sync(FULL, bound, c);
  const int comp = __shfl_sync(FULL, sidx, min(slot, C - 1));
  if (lane < M) comp_of[lane] = comp;
  if (open) {
    const int left = __shfl_sync(FULL, s_space - cnt, pos & 31);
    if (cl) space = left;
  }
}

// Lane n's extra pins when max_ppn > min_ppn (generate :407-450,
// allocate_pins_to_nets:1067): weights softmax(N(1/nn, 1/(net_distribution
// + 1))) from Box-Muller normals (draws 7 and 8), a multinomial of the
// `extra_total` extra pins (draw 9) capped at max_ppn - min_ppn per net,
// then an in-order water-fill of the residue.
__device__ int extra_pins(const FusedRolloutParams& p, const Rng& rng,
                          int nn, int extra_total, int lane) {
  const int N = p.nets, span = p.max_ppn - p.ppn, T = span * N;
  const bool open = lane < N && lane < nn;
  const float u1 = fmaxf(rng.uniform(7, N, lane), 1e-7f);
  const float u2 = rng.uniform(8, N, lane);
  const float r = (float)sqrt((double)(-2.0f * (float)log((double)u1)));
  const float z = r * (float)cos((double)(6.2831853f * u2));
  const float mean = 1.0f / (float)max(nn, 1);
  const float s = open ? mean + z / p.net_div : -1e9f;
  float smax = -1e9f;
  for (int n = 0; n < N; ++n) smax = fmaxf(smax, __shfl_sync(FULL, s, n));
  const float e = (float)exp((double)(s - smax));
  float tot = 0.f;  // in net order
  for (int n = 0; n < N; ++n) tot += __shfl_sync(FULL, e, n);
  float acc = 0.f, cprob = 0.f;
  for (int n = 0; n < N; ++n) {
    acc += __shfl_sync(FULL, e, n) / tot;
    if (lane == n) cprob = acc;
  }
  // draw 9: element j on lane j % 32, binned and counted by ballot
  const int draws = min(extra_total, T);
  int cnt = 0;
  for (int j0 = 0; j0 < draws; j0 += 32) {
    const int j = j0 + lane;
    const float ut = rng.uniform(9, T, j);
    int bin = 0;
    for (int c = 0; c < N - 1; ++c) bin += ut > __shfl_sync(FULL, cprob, c);
    for (int n = 0; n < N; ++n) {
      const int got = __popc(__ballot_sync(FULL, j < draws && bin == n));
      if (lane == n) cnt += got;
    }
  }
  const int cap = open ? min(span, extra_total) : 0;
  cnt = min(cnt, cap);
  const int resid = extra_total - warp_sum(cnt);
  const int free_n = cap - cnt;
  const int before = warp_scan(free_n, lane, N) - free_n;
  return lane < N ? cnt + min(max(resid - before, 0), free_n) : 0;
}

// The generator (generate, :363-601) into board `b`; `table` and `cells`
// are this warp's shared slices.
__device__ void generate(const FusedRolloutParams& p, const Rng& rng,
                         WarpBoard& b, int* table, int* cells, int lane) {
  const int C = p.components, N = p.nets, M = p.pins_per_net, P = p.pins;
  const int PPC = p.pins_per_component;
  // draws 2, 3, 4: component heights, widths, count
  b.numc = randint(p.min_c, p.max_c, rng.uniform(4, 1, 0));
  int h = randint(p.min_h, p.max_h, rng.uniform(2, C, lane));
  int w = randint(p.min_w, p.max_w, rng.uniform(3, C, lane));
  if (lane >= b.numc || lane >= C) h = w = 0;
  b.ch = h;
  b.cw = w;
  const int area = h * w;
  const int total_area = warp_sum(area);
  int space = area;
  // draw 5: net count; draw 6: total pin count, which feeds only the
  // max_ppn > min_ppn allocation (draws 7, 8, 9)
  int nn = randint(p.min_n, p.max_n, rng.uniform(5, 1, 0));
  nn = max(min(nn, total_area / 2), 1);
  int net_count = (lane < N && lane < nn) ? p.ppn : 0;
  uint32_t call_base = 7;
  if (p.max_ppn > p.ppn) {
    const int tp = min(
        randint(p.ppn * nn, p.max_ppn * nn, rng.uniform(6, 1, 0)),
        total_area);
    net_count += extra_pins(p, rng, nn, max(tp - p.ppn * nn, 0), lane);
    call_base = 10;
  }
  const int ncum = warp_scan(net_count, lane, N);
  const int num_pins = __shfl_sync(FULL, ncum, N - 1);
  b.npin = num_pins;

  int k0 = p.spatial ? (p.pin_spread * b.numc) / 10 + 1
                     : max(((p.pin_spread + 1) * b.numc) / 10, 1);
  k0 = min(k0, b.numc);
  __syncwarp();  // the last episode's reads of the tables are done
  for (int n = 0; n < N; ++n)  // draws call_base .. call_base+N-1
    allocate_net(p, rng, call_base + n, __shfl_sync(FULL, net_count, n), k0,
                 n < nn, space, table + n * M, lane);

  // draw call_base+N: a random cell order per component, the stable
  // ascending sort of uniform scores (unused cells 2.0) as ranks by
  // (score, index); lanes 16h.. rank component c0 + h
  for (int c0 = 0; c0 < C; c0 += 2) {
    const int c = c0 + (lane >> 4), k = lane & 15;
    const int ac = __shfl_sync(FULL, area, min(c, C - 1));
    const bool mine = c < C && k < PPC;
    const float v = mine && k < ac
                        ? rng.uniform(call_base + N, C * PPC, c * PPC + k)
                        : 2.0f;
    int rank = 0;
    for (int k2 = 0; k2 < PPC; ++k2) {
      const float o = __shfl_sync(FULL, v, (lane & 16) | k2);
      rank += o < v || (o == v && k2 < k);
    }
    if (mine) cells[c * PPC + rank] = k;
  }
  __syncwarp();

  // the pins: net, rank in net, component, rank in component, cell
  int net[2] = {0, 0};
  for (int n = 0; n < N; ++n) {
    const int bound = __shfl_sync(FULL, ncum, n);
    net[0] += lane >= bound;
    net[1] += lane + 32 >= bound;
  }
  int comp[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int q = lane + 32 * s;
    const int nc = min(net[s], N - 1);
    const int prev = __shfl_sync(FULL, ncum, max(nc - 1, 0));
    const int rank = q - (nc > 0 ? prev : 0);
    const bool in_use = q < num_pins && q < P;
    comp[s] = in_use ? table[nc * M + min(max(rank, 0), M - 1)] : -1;
  }
  // rank among the earlier pins of the same component (the per-thread
  // ccount[comp]++ in pin order)
  const uint32_t lower = (1u << lane) - 1u;
  int crank[2];
  crank[0] = __popc(__match_any_sync(FULL, comp[0]) & lower);
  crank[1] = 0;
  if (P > 32) {
    int of0 = 0;  // lane c: slot-0 pins of component c
    for (int c = 0; c < C; ++c) {
      const int got = __popc(__ballot_sync(FULL, comp[0] == c));
      if (lane == c) of0 = got;
    }
    const int before = __shfl_sync(FULL, of0, min(max(comp[1], 0), 31));
    crank[1] = before + __popc(__match_any_sync(FULL, comp[1]) & lower);
  }
  const int wlo = max(p.min_w, 1);
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int q = lane + 32 * s, cp = comp[s];
    const int r = (cp >= 0 && cp < C) ? crank[s] : 0;
    const int wp = __shfl_sync(FULL, b.cw, min(max(cp, 0), 31));
    int rx = 0, ry = 0;
    if (q < P) {
      const int cell = cells[max(cp, 0) * PPC + min(max(r, 0), PPC - 1)];
      if (wp >= wlo && wp <= p.max_w) {
        rx = cell / wp;
        ry = cell % wp;
      }
    }
    const bool in_use = q < num_pins && q < P;
    b.prx[s] = cp >= 0 ? rx : -1;
    b.pry[s] = cp >= 0 ? ry : -1;
    b.pax[s] = b.pay[s] = -1;
    b.pnet[s] = in_use ? net[s] : -1;
    b.pcomp[s] = cp;
  }
  b.grid = 0u;
  b.cur = 0;
  planes_for(p, b, __shfl_sync(FULL, b.ch, 0), __shfl_sync(FULL, b.cw, 0),
             true, lane);
}

// ---- one step (body) -----------------------------------------------------

__device__ void step(const FusedRolloutParams& p, const Rng& rng,
                     WarpBoard& b, float& rsum, int& dcnt, int* table,
                     int* cells, int lane) {
  const int H = p.height, W = p.width, C = p.components, P = p.pins;
  // sample a legal action over four planes (2 and 3 copy 0 and 1)
  const int c0 = plane_count(b.pl0), c1 = plane_count(b.pl1);
  const float total = 2.0f * (float)(c0 + c1);
  const float u = rng.uniform(1, 1, 0);
  float tgt = fminf(floorf(u * total), total - 1.0f);
  tgt = fmaxf(tgt, 0.0f);
  const float pre1 = (float)c0;
  const float pre2 = (float)(c0 + c1);
  const float pre3 = pre2 + (float)c0;
  const int osel = (tgt >= pre1) + (tgt >= pre2) + (tgt >= pre3);
  const float tin = tgt - (osel == 0   ? 0.0f
                           : osel == 1 ? pre1
                           : osel == 2 ? pre2
                                       : pre3);
  const bool even = osel % 2 == 0;
  const int idx = nth_cell(p, even ? b.pl0 : b.pl1, (int)tin, lane);
  const bool alive = total > 0.0f;
  const int xx = idx / W, yy = idx % W;

  const int chc = comp_at(b.ch, b.cur, C), cwc = comp_at(b.cw, b.cur, C);
  if (alive) {
    // paint the footprint
    const int ph = even ? chc : cwc, pw = even ? cwc : chc;
    const uint64_t wmask = (1ull << W) - 1ull;
    const uint32_t cols =
        (uint32_t)(((((1ull << max(pw, 0)) - 1ull) << yy)) & wmask);
    if (lane >= xx && lane < min(xx + ph, H)) b.grid |= cols;
    // pin rotation (Component.place_component:156-204)
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (lane + 32 * s >= P || b.pcomp[s] != b.cur) continue;
      const int r0 = b.prx[s], r1 = b.pry[s];
      const int nrx = osel == 0 ? r0 : osel == 1 ? r1
                    : osel == 2 ? chc - r0 - 1 : cwc - r1 - 1;
      const int nry = osel == 0 ? r1 : osel == 1 ? chc - r0 - 1
                    : osel == 2 ? cwc - r1 - 1 : r0;
      b.prx[s] = nrx;
      b.pry[s] = nry;
      b.pax[s] = xx + nrx;
      b.pay[s] = yy + nry;
    }
    ++b.cur;
  }
  const bool placed_all = b.cur >= b.numc;
  planes_for(p, b, comp_at(b.ch, b.cur, C), comp_at(b.cw, b.cur, C),
             !placed_all, lane);
  const int nt = plane_count(b.pl0) + plane_count(b.pl1);
  const bool done = placed_all || nt == 0 || !alive;
  if (!done) return;
  // routed reward on the post-placement tables, else the penalty
  const float reward =
      (placed_all && alive) ? routed_reward(p, b, lane) : p.penalty;
  rsum = rsum + reward;
  ++dcnt;
  generate(p, rng, b, table, cells, lane);
}

// ---- the kernel ------------------------------------------------------------

__global__ void __launch_bounds__(BLOCK_THREADS, MIN_BLOCKS)
fused_rollout_warp_kernel(FusedRolloutParams p, FusedRolloutLeaves in,
                          FusedRolloutLeaves out, float* rsum_out,
                          int32_t* dcnt_out, int batch, int num_steps,
                          int block, uint32_t seed) {
  __shared__ int s_table[WARPS][MAX_N * MAX_M];
  __shared__ int s_cells[WARPS][MAX_C * MAX_PPC];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bi = blockIdx.x * WARPS + warp;
  if (bi >= batch) return;  // the whole warp; no block barrier follows
  const int H = p.height, W = p.width, A = H * W, C = p.components;
  const int P = p.pins;
  const int64_t b = bi;

  WarpBoard bd;
  // rows: lane y reads cell (x, y), the ballot is row x's mask
  bd.grid = bd.pl0 = bd.pl1 = 0u;
  for (int x = 0; x < H; ++x) {
    const int64_t a = b * A + x * W + lane;
    const bool col = lane < W;
    const uint32_t g = __ballot_sync(FULL, col && in.grid[a] != 0.0f);
    const uint32_t m0 = __ballot_sync(FULL, col && in.plane0[a] != 0.0f);
    const uint32_t m1 = __ballot_sync(FULL, col && in.plane1[a] != 0.0f);
    if (lane == x) {
      bd.grid = g;
      bd.pl0 = m0;
      bd.pl1 = m1;
    }
  }
  bd.ch = lane < C ? in.comp_h[b * C + lane] : 0;
  bd.cw = lane < C ? in.comp_w[b * C + lane] : 0;
  bd.cur = in.cursor[b];
  bd.numc = in.num_components[b];
  bd.npin = in.num_pins[b];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int q = lane + 32 * s;
    const bool ok = q < P;
    const int64_t a = b * P + q;
    bd.prx[s] = ok ? in.pin_rel_x[a] : -1;
    bd.pry[s] = ok ? in.pin_rel_y[a] : -1;
    bd.pax[s] = ok ? in.pin_abs_x[a] : -1;
    bd.pay[s] = ok ? in.pin_abs_y[a] : -1;
    bd.pnet[s] = ok ? in.pin_net[a] : -1;
    bd.pcomp[s] = ok ? in.pin_comp[a] : -1;
  }

  Rng rng;
  rng.row = (uint32_t)(bi % block);
  const uint32_t blk_salt = block_salt(bi, block, seed);
  float rsum = 0.0f;
  int dcnt = 0;
  for (int t = 0; t < num_steps; ++t) {
    rng.salt = step_salt(blk_salt, t);
    step(p, rng, bd, rsum, dcnt, s_table[warp], s_cells[warp], lane);
  }

  for (int x = 0; x < H; ++x) {
    const uint32_t g = __shfl_sync(FULL, bd.grid, x);
    const uint32_t m0 = __shfl_sync(FULL, bd.pl0, x);
    const uint32_t m1 = __shfl_sync(FULL, bd.pl1, x);
    if (lane < W) {
      const int64_t a = b * A + x * W + lane;
      out.grid[a] = (float)((g >> lane) & 1u);
      out.plane0[a] = (float)((m0 >> lane) & 1u);
      out.plane1[a] = (float)((m1 >> lane) & 1u);
    }
  }
  if (lane < C) {
    out.comp_h[b * C + lane] = bd.ch;
    out.comp_w[b * C + lane] = bd.cw;
  }
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int q = lane + 32 * s;
    if (q >= P) continue;
    const int64_t a = b * P + q;
    out.pin_rel_x[a] = bd.prx[s];
    out.pin_rel_y[a] = bd.pry[s];
    out.pin_abs_x[a] = bd.pax[s];
    out.pin_abs_y[a] = bd.pay[s];
    out.pin_net[a] = bd.pnet[s];
    out.pin_comp[a] = bd.pcomp[s];
  }
  if (lane == 0) {
    out.cursor[b] = bd.cur;
    out.num_components[b] = bd.numc;
    out.num_pins[b] = bd.npin;
    rsum_out[b] = rsum;
    dcnt_out[b] = dcnt;
  }
}

}  // namespace

int fused_rollout_warp_launch(const FusedRolloutParams& p,
                              const FusedRolloutLeaves& in,
                              const FusedRolloutLeaves& out, float* rsum,
                              int32_t* dcnt, int batch, int num_steps,
                              int block, uint32_t seed, cudaStream_t stream) {
  const int grid = (batch + WARPS - 1) / WARPS;
  fused_rollout_warp_kernel<<<grid, BLOCK_THREADS, 0, stream>>>(
      p, in, out, rsum, dcnt, batch, num_steps, block, seed);
  return (int)cudaGetLastError();
}

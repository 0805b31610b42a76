// Fused rollout chunk of the pin kernels, one warp per board: K_CENTROID,
// K_BEAM and K_BOTH, one instantiation of fused_rollout_warp_kernel<K> each,
// the board's state in registers spread over the warp's lanes.
//
// Replaces the Pallas TPU kernel of placement_tpu/ops/fused_rollout.py
// (make_fused_rollout's pl.pallas_call at :866, body _build_kernel
// :290-763) for PIN / PIN_SPATIAL, with fixed or varying pins per net, and
// the routing reward of reward_rows (placement_tpu/ops/fused_routing.py
// :406-430): the centroid route (centroid_wl_int :85-173), the beam-search
// route (beam_wl_int :355-399, _beam_net :235-352), or both, where the
// route with fewer crossings wins and a tie goes to beam.
//
// What bounds it on an H100: scalar operations, not bytes. A board-step of
// the flagship (10x10 grid, 5 components, 3 nets x 6 pins) is ~450 integer
// operations (sampling, paint, pin rotation, two legality planes); an
// episode (one step in five) adds ~1.3k for the generator and the reward:
// ~4.2k for the centroid route (108 segment pairs on different nets at ~35
// operations each, plus the per-pin terms); for the beam route at width bw,
// per net and round, bw^2 nearest-pin scans of M pins and a selection of bw
// of the bw^2 candidates, then 75 segment pairs. chip_smoke.py's
// _chunk_bound counts them for a run's own boards; the integer operations
// at the card's integer issue rate bind. The leaves are ~1.7 KB per board,
// read and written once: ~14 MB, ~4 us at 3.35 TB/s.
//
// What the design does about it. A one-thread-per-board kernel keeps each
// board, its beams and candidates in a 3-4 KB stack frame indexed
// dynamically; 128 such frames per SM overflow L1, so its serial chain of a
// few thousand instructions per board-step runs at tens of cycles each from
// L2, and in a warp the boards that end an episode route while the others
// wait. Here:
//   * a board is a warp: lane x holds grid row x and the two legality-plane
//     rows (MAX_H = 32), lane q holds pins q and q + 32 (MAX_P <= 64),
//     lane c component c; cursor, component and pin counts are uniform.
//     Only the two tables read at computed indices live in shared memory,
//     a slice per warp: the per-net allocation table and the cell order;
//   * the loops over rows, pins, components and nets run across the lanes
//     (shuffles, ballots, warp sums, __match_any_sync), so the serial chain
//     of a board-step is tens of warp operations, not thousands; the row
//     helpers are fused_warp.cuh's, shared with the reduced kernels;
//   * the beam search routes floor(32 / M) nets at once: lane n*M + j holds
//     pin j of net n (all of the flagship's 3 x 6 pins, of the varying-pins
//     parity config's 4 x 5), and the beam's state is held on the net's
//     lanes: lane t the lane of each beam's path position t and whether each
//     beam has visited pin t (a byte and a bit per beam), lane j the
//     candidate of each beam whose new pin is j. A nearest-pin scan is a
//     segmented min over the net's lanes and a ballot (first wins); a
//     selection is a segmented min of the unique 64-bit key (cost, the
//     parent path's rank, the new pin's key, the candidate's index). A
//     path's rank among the beams follows from its parent's rank and its
//     new pin's key, so no path is compared position by position. The
//     crossings test the segments of a shared-memory slice, pair by pair
//     across the lanes;
//   * 8 boards per 256-thread block, at most 64 registers a thread in all
//     three instantiations: all of 4096 boards (31 warps per SM on 132 SMs)
//     are resident at once. The beam's state spills a few words (8-16 B);
//     that costs less than the occupancy that more registers would lose.
// Each reward has two instantiations, fused_rollout_warp_kernel<K, GENERAL>.
// The default one (the flagship's, every config within DEFAULT_N nets of
// DEFAULT_M pins on a board of sides <= 32) is the design above. The general
// one takes the JAX kernel's whole envelope: the board as its bit string
// over the lanes (fused_warp.cuh's flat layout, a side may pass 32), a net's
// ranks 32.. on a second lane slot in the allocation, and the beam search
// one net a turn on the whole warp (beam_wl_int_general: pin j on lane
// j % 32, slot j / 32, coordinates up to 254), at up to 128 registers.
// Every f32 sum whose order the plain version fixes is still taken in that
// order (the wirelength over pins, or over nets and path positions, the
// allocation's weights, the softmax total and cumulative probabilities, the
// per-board reward sum): lane 0's order, broadcast. Integer sums (and f32
// sums of small integers, exact in any order) are warp reductions. Every
// sort is a rank by counting over unique keys, which gives the stable
// sort's order. The PRNG row and salt are those of the LOGICAL block,
// whatever the launch geometry. Build with -fmad=false, IEEE division and
// sqrt; the allocation's log, cos, exp and sqrt are taken in f64 and
// rounded to f32, as in the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_common.cuh"
#include "fused_warp.cuh"

namespace {

constexpr int WARPS = 8;                 // boards per block
constexpr int BLOCK_THREADS = 32 * WARPS;
constexpr int MIN_BLOCKS = 4;            // 64 registers a thread
constexpr int MIN_BLOCKS_GENERAL = 2;    // 128: the general beam's state

static_assert(MAX_P <= 64 && MAX_M <= 64, "two pin slots per lane");
static_assert(MAX_C <= 32 && MAX_N <= 32, "a lane per component and net");
static_assert(MAX_PPC <= 16, "two components' cells per warp pass");

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

template <bool FLAT>
__device__ __forceinline__ void planes_for(const FusedRolloutParams& p,
                                           WarpBoard& b, int ch_c, int cw_c,
                                           bool alive, int lane) {
  if (!alive) {
    b.pl0 = b.pl1 = 0u;
    return;
  }
  b.pl0 = free_row<false, FLAT>(p, b.grid, ch_c, cw_c, lane);
  b.pl1 = free_row<false, FLAT>(p, b.grid, cw_c, ch_c, lane);
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

// ---- beam-search routing reward (fused_routing.beam_wl_int) ---------------

constexpr float BIG = 1e9f;       // dead-path cost, routing.BIG
constexpr float INF2 = 2e9f;      // "already selected" marker
constexpr float NO_CAND = 3e9f;   // no candidate on this lane
constexpr int NO_SEG = -1;        // no route segment in this slot

static_assert(MAX_BW <= 4, "a byte of a path position, 2 bits of an index");
static_assert(DEFAULT_M <= 16, "a beam's lane in 4 bits, 2+ nets a turn");
static_assert(DEFAULT_N * DEFAULT_M <= 4 * 32, "4 segment slots per lane");

// The min of v over the lanes [base, base + M) of the caller's net, on
// every lane of it (j = lane - base): a suffix min towards lane base, then
// its broadcast.
template <class T>
__device__ __forceinline__ T seg_min(T v, int j, int M, int base) {
  for (int d = 1; d < M; d <<= 1) {
    const T o = __shfl_down_sync(FULL, v, d);
    if (j + d < M && o < v) v = o;
  }
  return __shfl_sync(FULL, v, base);
}

__device__ __forceinline__ int seg_sum(int v, int j, int M, int base) {
  for (int d = 1; d < M; d <<= 1) {
    const int o = __shfl_down_sync(FULL, v, d);
    if (j + d < M) v += o;
  }
  return __shfl_sync(FULL, v, base);
}

// The first lane of the caller's net where `hit` holds (0 if none).
__device__ __forceinline__ int seg_first(bool hit, int base,
                                         uint32_t segmask) {
  return max(__ffs((__ballot_sync(FULL, hit) >> base) & segmask) - 1, 0);
}

// A route segment's endpoints (coordinates 0..31), a byte each.
__device__ __forceinline__ int pack_seg(float x1, float y1, float x2,
                                        float y2) {
  return (int)x1 | (int)y1 << 8 | (int)x2 << 16 | (int)y2 << 24;
}

__device__ __forceinline__ float seg_coord(int s, int i) {
  return (float)((s >> (8 * i)) & 0xff);
}

// Beam-route wirelength and crossing count (the same on every lane): every
// net routed by beam search from its outlier pin, cnt - 1 segments per net.
// `segs` is the warp's shared slice of MAX_N * MAX_M words (the generator's
// allocation table, which is rewritten before its next read).
//
// Beam search per net, as _beam_net: the start is the pin farthest from the
// centroid (first max wins; lane 0 for a net without pins); each of lim - 1
// rounds expands every beam to its bw nearest untaken pins (first wins,
// visited pins at cost BIG), candidates indexed parent-major, and keeps the
// bw best by (cost, parent path's keys, new pin's key), first wins; the
// route is the best final beam by (cost, path keys). Two details differ
// from the plain version and cannot change the route:
//   * a path's keys are compared through ranks: a new beam's path is its
//     parent's plus one pin, so its rank among the new beams is that of
//     (the parent's rank, the new pin's key);
//   * when bw > M a beam runs out of lanes and the plain version adds
//     candidates at lane 0 and cost BIG; here they are left out. Each beam
//     still has min(bw, M) >= 1 candidates, so bw are always kept. A beam
//     of cost BIG (dead) never has a live child, and while a net has pins
//     left the best beam is live, so live beams rank first in every round
//     and in the final pick whatever the dead ones' order.
__device__ void beam_wl_int(const FusedRolloutParams& p, const WarpBoard& b,
                            int lane, int* segs, float& wl_out,
                            int& ints_out) {
  const int N = p.nets, M = p.pins_per_net, P = p.pins, bw = p.beam_width;
  const int G = 32 / M;                          // nets a turn
  const int g = lane / M, j = lane - g * M, base = g * M;
  const uint32_t segmask = (1u << M) - 1u;
  // a pin's net, or -1 where it is not routed
  int net_on[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int q = lane + 32 * s, n = b.pnet[s];
    net_on[s] = (q < P && q < b.npin && n >= 0 && n < N) ? n : -1;
  }
  // lane n: net n's pin count and first pin
  int cnt_l = 0;
  for (int n = 0; n < N; ++n) {
    const int c = warp_sum((net_on[0] == n) + (net_on[1] == n));
    if (lane == n) cnt_l = c;
  }
  const int start_l = warp_scan(cnt_l, lane, N) - cnt_l;
  __syncwarp();  // the generator's reads of the shared slice are done

  float wl = 0.f;
  for (int n0 = 0; n0 < N; n0 += G) {
    const int n = n0 + g;
    const bool real = g < G && n < N;
    const int cnt_n = __shfl_sync(FULL, cnt_l, n & 31);
    const int st_n = __shfl_sync(FULL, start_l, n & 31);
    const int cnt = real ? cnt_n : 0;
    const int lim = min(cnt, M);
    // lane j: the net's pin of rank j, table position start + j
    const int q = (real ? st_n : 0) + j, src = q & 31;
    const int n_lo = __shfl_sync(FULL, net_on[0], src);
    const int n_hi = __shfl_sync(FULL, net_on[1], src);
    const int x_lo = __shfl_sync(FULL, b.pax[0], src);
    const int x_hi = __shfl_sync(FULL, b.pax[1], src);
    const int y_lo = __shfl_sync(FULL, b.pay[0], src);
    const int y_hi = __shfl_sync(FULL, b.pay[1], src);
    const bool hi = q >= 32;
    const bool has = real && q < 64 && (hi ? n_hi : n_lo) == n;
    const float x = has ? (float)(hi ? x_hi : x_lo) : 0.f;
    const float y = has ? (float)(hi ? y_hi : y_lo) : 0.f;
    // the pin's key: the order of x * 32768 + y
    const uint32_t key = (uint32_t)(((int)x + 1) * 64 + ((int)y + 1));
    const bool present = j < lim;

    // start: the pin farthest from the net centroid (coordinate sums are
    // small integers, exact in any order)
    const int sxi = seg_sum(present ? (int)x : 0, j, M, base);
    const int syi = seg_sum(present ? (int)y : 0, j, M, base);
    const float denom = (float)max(cnt, 1);
    const float cx = (float)sxi / denom, cy = (float)syi / denom;
    const float ex = x - cx, ey = y - cy;
    const float d0 = present ? sqrtf(ex * ex + ey * ey) : -1.f;
    const float dmax = -seg_min(-d0, j, M, base);
    const int start = seg_first(d0 == dmax, base, segmask);

    // the beams: cost, last pin (4 bits each) and path rank (segment-
    // uniform); lane t: byte k = beam k's lane at path position t, bit k of
    // `visb` = beam k has visited (or has no) pin t
    float cost[MAX_BW];
#pragma unroll
    for (int k = 0; k < MAX_BW; ++k) cost[k] = k == 0 ? 0.f : BIG;
    uint32_t curs = (uint32_t)start * 0x1111u, ranks = 0u;
    uint32_t path = j == 0 ? (uint32_t)start * 0x01010101u : 0u;
    uint32_t visb = (j == start || !present) ? 0xfu : 0u;
    const int rounds = (int)__reduce_max_sync(FULL, (unsigned)max(lim - 1, 0));

    for (int step = 0; step < rounds; ++step) {
      const bool active = step + 1 <= lim - 1;
      // this lane's candidate of each beam: cost, nearest-pin rank c
      float cc[MAX_BW];
      uint32_t cn = 0u;
#pragma unroll
      for (int k = 0; k < MAX_BW; ++k) {
        cc[k] = NO_CAND;
        if (k >= bw) continue;
        const int cur = (int)(curs >> (4 * k)) & 0xf;
        const float curx = __shfl_sync(FULL, x, base + cur);
        const float cury = __shfl_sync(FULL, y, base + cur);
        const float dx = x - curx, dy = y - cury;
        const float d = (visb >> k) & 1u ? BIG : sqrtf(dx * dx + dy * dy);
        bool taken = false;
        for (int c = 0; c < bw; ++c) {
          // the nearest lane not taken yet, first wins
          const float eff = taken ? INF2 : d;
          const float m = seg_min(eff, j, M, base);
          const int jj = seg_first(eff == m, base, segmask);
          if (m < INF2 && j == jj) {
            taken = true;
            const float ccost = cost[k] + m;
            cc[k] = ccost >= BIG ? BIG : ccost;
            cn |= (uint32_t)c << (2 * k);
          }
        }
      }
      // keep the bw best: new beam k2 is the candidate of rank k2, found as
      // the segment's min key; sel[k2] = its key's low bits (the parent's
      // rank, the new pin's key, the parent k, c) and its lane at bit 20
      uint32_t sel[MAX_BW];
#pragma unroll
      for (int k2 = 0; k2 < MAX_BW; ++k2) {
        sel[k2] = 0u;
        if (k2 >= bw) continue;
        uint64_t mine = ~0ull;
#pragma unroll
        for (int k = 0; k < MAX_BW; ++k) {
          if (k >= bw || cc[k] > BIG) continue;
          const uint32_t rk = (ranks >> (2 * k)) & 3u;
          const uint32_t lo = rk << 16 | key << 4 | (uint32_t)k << 2 |
                              ((cn >> (2 * k)) & 3u);
          const uint64_t o = (uint64_t)__float_as_uint(cc[k]) << 32 | lo;
          mine = o < mine ? o : mine;
        }
        const uint64_t w = seg_min(mine, j, M, base);
        const int win = seg_first(mine == w, base, segmask);
        const int kp = (int)(w >> 2) & 3;
#pragma unroll
        for (int k = 0; k < MAX_BW; ++k)
          if (j == win && k == kp) cc[k] = NO_CAND;
        sel[k2] = ((uint32_t)w & 0x3ffffu) | (uint32_t)win << 20;
        if (active) cost[k2] = __uint_as_float((uint32_t)(w >> 32));
      }
      if (!active) continue;
      // the new beams' ranks, last pins, paths and visited pins
      uint32_t nranks = 0u, ncurs = 0u, npath = 0u, nvisb = 0u;
#pragma unroll
      for (int k2 = 0; k2 < MAX_BW; ++k2) {
        if (k2 >= bw) continue;
        const uint32_t pk = (sel[k2] >> 4) & 0x3fffu;  // parent rank, key
        uint32_t r = 0u;
#pragma unroll
        for (int k3 = 0; k3 < MAX_BW; ++k3)
          r += k3 < bw && ((sel[k3] >> 4) & 0x3fffu) < pk;
        const int par = (int)(sel[k2] >> 2) & 3;
        const uint32_t jj = sel[k2] >> 20;
        nranks |= r << (2 * k2);
        ncurs |= jj << (4 * k2);
        const uint32_t pbyte = (path >> (8 * par)) & 0xffu;
        const uint32_t byte =
            j <= step ? pbyte : (j == step + 1 ? jj : 0u);
        npath |= byte << (8 * k2);
        nvisb |= (((visb >> par) & 1u) | (uint32_t)(j == (int)jj)) << k2;
      }
      ranks = nranks;
      curs = ncurs;
      path = npath;
      visb = nvisb;
    }

    // the route: the best beam by (cost, path rank), first wins
    int best = 0;
    float bc = cost[0];
    uint32_t br = ranks & 3u;
#pragma unroll
    for (int k = 1; k < MAX_BW; ++k) {
      const uint32_t rk = (ranks >> (2 * k)) & 3u;
      if (k < bw && (cost[k] < bc || (cost[k] == bc && rk < br))) {
        best = k;
        bc = cost[k];
        br = rk;
      }
    }
    const int rl = (int)(path >> (8 * best)) & 0xff;
    const float rx = __shfl_sync(FULL, x, base + rl);
    const float ry = __shfl_sync(FULL, y, base + rl);
    const float rx2 = __shfl_down_sync(FULL, rx, 1);
    const float ry2 = __shfl_down_sync(FULL, ry, 1);
    const bool sv = real && j + 1 <= lim - 1;
    const float ddx = rx - rx2, ddy = ry - ry2;
    const float term = sv ? sqrtf(ddx * ddx + ddy * ddy) : 0.f;
    // the wirelength, nets outer, positions inner (adding +0 past a net's
    // last segment is exact)
    for (int gg = 0; gg < G && n0 + gg < N; ++gg)
      for (int t = 0; t < rounds; ++t)
        wl += __shfl_sync(FULL, term, gg * M + t);
    if (real) segs[n * M + j] = sv ? pack_seg(rx, ry, rx2, ry2) : NO_SEG;
  }
  __syncwarp();

  // crossings of segments on different nets: segment a broadcast from
  // shared memory, the later nets' segments on the lanes' own slots
  int own[4], own_net[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = lane + 32 * r;
    own[r] = i < N * M ? segs[i] : NO_SEG;
    own_net[r] = i / M;
  }
  int ints = 0;
  for (int na = 0; na + 1 < N; ++na) {
    for (int t = 0; t + 1 < M; ++t) {
      const int sa = segs[na * M + t];
      if (sa == NO_SEG) continue;
      const float ax1 = seg_coord(sa, 0), ay1 = seg_coord(sa, 1);
      const float ax2 = seg_coord(sa, 2), ay2 = seg_coord(sa, 3);
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (own[r] != NO_SEG && own_net[r] > na)
          ints += seg_intersect(ax1, ay1, ax2, ay2, seg_coord(own[r], 0),
                                seg_coord(own[r], 1), seg_coord(own[r], 2),
                                seg_coord(own[r], 3));
    }
  }
  wl_out = wl;
  ints_out = warp_sum(ints);
}

// ---- the general instantiation's beam route (nets of up to 48 pins) ------

// The min of v over the warp, on every lane.
template <class T>
__device__ __forceinline__ T warp_min(T v) {
  for (int d = 16; d >= 1; d >>= 1) {
    const T o = __shfl_xor_sync(FULL, v, d);
    v = o < v ? o : v;
  }
  return v;
}

// The first pin j (lane j % 32, slot j / 32) where `hit` holds, 0 if none.
__device__ __forceinline__ int first_pin(bool hit0, bool hit1) {
  const uint32_t b0 = __ballot_sync(FULL, hit0);
  const uint32_t b1 = __ballot_sync(FULL, hit1);
  return b0 ? __ffs(b0) - 1 : (b1 ? 31 + __ffs(b1) : 0);
}

// The value of a pin-indexed pair at pin j (uniform j < 64).
__device__ __forceinline__ float pin_at(const float (&v)[2], int j) {
  const float lo = __shfl_sync(FULL, v[0], j & 31);
  const float hi = __shfl_sync(FULL, v[1], j & 31);
  return j < 32 ? lo : hi;
}

// beam_wl_int for any net of up to MAX_M pins and coordinates up to 254:
// the same search, tie rules and sums, one net a turn on the whole warp.
// Net rank j's pin, its candidate of each beam, whether each beam has
// visited it and each beam's path position j live on lane j % 32, slot
// j / 32; a beam's last pin takes a byte of `curs`, the pin's key 16 bits
// of the selection key, the winning pin 6 bits of `sel`.
__device__ void beam_wl_int_general(const FusedRolloutParams& p,
                                    const WarpBoard& b, int lane, int* segs,
                                    float& wl_out, int& ints_out) {
  const int N = p.nets, M = p.pins_per_net, P = p.pins, bw = p.beam_width;
  // a pin's net, or -1 where it is not routed
  int net_on[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int q = lane + 32 * s, n = b.pnet[s];
    net_on[s] = (q < P && q < b.npin && n >= 0 && n < N) ? n : -1;
  }
  // lane n: net n's pin count and first pin
  int cnt_l = 0;
  for (int n = 0; n < N; ++n) {
    const int c = warp_sum((net_on[0] == n) + (net_on[1] == n));
    if (lane == n) cnt_l = c;
  }
  const int start_l = warp_scan(cnt_l, lane, N) - cnt_l;
  __syncwarp();  // the generator's reads of the shared slice are done

  float wl = 0.f;
  for (int n = 0; n < N; ++n) {
    const int cnt = __shfl_sync(FULL, cnt_l, n);
    const int st = __shfl_sync(FULL, start_l, n);
    const int lim = min(cnt, M);
    // rank j = lane + 32 s: the net's pin at table position st + j
    float x[2], y[2];
    uint32_t key[2];
    bool inseg[2], present[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int j = lane + 32 * s, q = st + j, src = q & 31;
      const int n_lo = __shfl_sync(FULL, net_on[0], src);
      const int n_hi = __shfl_sync(FULL, net_on[1], src);
      const int x_lo = __shfl_sync(FULL, b.pax[0], src);
      const int x_hi = __shfl_sync(FULL, b.pax[1], src);
      const int y_lo = __shfl_sync(FULL, b.pay[0], src);
      const int y_hi = __shfl_sync(FULL, b.pay[1], src);
      const bool hi = q >= 32;
      inseg[s] = j < M;
      const bool has = inseg[s] && q < 64 && (hi ? n_hi : n_lo) == n;
      x[s] = has ? (float)(hi ? x_hi : x_lo) : 0.f;
      y[s] = has ? (float)(hi ? y_hi : y_lo) : 0.f;
      // the pin's key: the order of x * 32768 + y
      key[s] = (uint32_t)(((int)x[s] + 1) << 8 | ((int)y[s] + 1));
      present[s] = j < lim;
    }

    // start: the pin farthest from the net centroid (coordinate sums are
    // small integers, exact in any order)
    const int sxi = warp_sum((present[0] ? (int)x[0] : 0) +
                             (present[1] ? (int)x[1] : 0));
    const int syi = warp_sum((present[0] ? (int)y[0] : 0) +
                             (present[1] ? (int)y[1] : 0));
    const float denom = (float)max(cnt, 1);
    const float cx = (float)sxi / denom, cy = (float)syi / denom;
    float d0[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const float ex = x[s] - cx, ey = y[s] - cy;
      d0[s] = present[s] ? sqrtf(ex * ex + ey * ey) : -1.f;
    }
    const float dmax = -warp_min(-fmaxf(d0[0], d0[1]));
    const int start = first_pin(d0[0] == dmax, d0[1] == dmax);

    // the beams: cost, last pin (a byte each), path rank (2 bits each);
    // pin j: byte k of path[s] = beam k's pin at path position j, bit k of
    // visb[s] = beam k has visited (or has no) pin j
    float cost[MAX_BW];
#pragma unroll
    for (int k = 0; k < MAX_BW; ++k) cost[k] = k == 0 ? 0.f : BIG;
    uint32_t curs = (uint32_t)start * 0x01010101u, ranks = 0u;
    uint32_t path[2], visb[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int j = lane + 32 * s;
      path[s] = j == 0 ? (uint32_t)start * 0x01010101u : 0u;
      visb[s] = (j == start || !present[s]) ? 0xfu : 0u;
    }
    const int rounds = max(lim - 1, 0);

    for (int step = 0; step < rounds; ++step) {
      // each pin's candidate of each beam: cost, nearest-pin rank c
      float cc[2][MAX_BW];
      uint32_t cn[2] = {0u, 0u};
#pragma unroll
      for (int k = 0; k < MAX_BW; ++k) {
        cc[0][k] = cc[1][k] = NO_CAND;
        if (k >= bw) continue;
        const int cur = (int)(curs >> (8 * k)) & 0xff;
        const float curx = pin_at(x, cur), cury = pin_at(y, cur);
        float d[2];
        bool taken[2] = {false, false};
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const float dx = x[s] - curx, dy = y[s] - cury;
          d[s] = (visb[s] >> k) & 1u ? BIG : sqrtf(dx * dx + dy * dy);
        }
        for (int c = 0; c < bw; ++c) {
          // the nearest pin not taken yet, first wins; no pin past M
          const float e0 = !inseg[0] || taken[0] ? INF2 : d[0];
          const float e1 = !inseg[1] || taken[1] ? INF2 : d[1];
          const float m = warp_min(fminf(e0, e1));
          const int jj = first_pin(e0 == m, e1 == m);
          if (m < INF2 && lane == (jj & 31)) {
            const int s = jj >> 5;
            const float ccost = cost[k] + m;
            const float v = ccost >= BIG ? BIG : ccost;
            if (s == 0) {
              taken[0] = true;
              cc[0][k] = v;
              cn[0] |= (uint32_t)c << (2 * k);
            } else {
              taken[1] = true;
              cc[1][k] = v;
              cn[1] |= (uint32_t)c << (2 * k);
            }
          }
        }
      }
      // keep the bw best: new beam k2 is the candidate of rank k2, found as
      // the warp's min key; sel[k2] = its key's low bits (the parent's
      // rank, the new pin's key, the parent k, c) and its pin at bit 22
      uint32_t sel[MAX_BW];
#pragma unroll
      for (int k2 = 0; k2 < MAX_BW; ++k2) {
        sel[k2] = 0u;
        if (k2 >= bw) continue;
        uint64_t mine = ~0ull;
        int mine_s = 0;
#pragma unroll
        for (int s = 0; s < 2; ++s) {
#pragma unroll
          for (int k = 0; k < MAX_BW; ++k) {
            if (k >= bw || cc[s][k] > BIG) continue;
            const uint32_t rk = (ranks >> (2 * k)) & 3u;
            const uint32_t lo = rk << 20 | key[s] << 4 | (uint32_t)k << 2 |
                                ((cn[s] >> (2 * k)) & 3u);
            const uint64_t o = (uint64_t)__float_as_uint(cc[s][k]) << 32 | lo;
            if (o < mine) {
              mine = o;
              mine_s = s;
            }
          }
        }
        const uint64_t w = warp_min(mine);
        const int win = max(__ffs(__ballot_sync(FULL, mine == w)) - 1, 0);
        const int ws = __shfl_sync(FULL, mine_s, win);
        const int kp = (int)(w >> 2) & 3;
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
          for (int k = 0; k < MAX_BW; ++k)
            if (lane == win && s == ws && k == kp) cc[s][k] = NO_CAND;
        sel[k2] = ((uint32_t)w & 0x3fffffu) | (uint32_t)(win + 32 * ws) << 22;
        cost[k2] = __uint_as_float((uint32_t)(w >> 32));
      }
      // the new beams' ranks, last pins, paths and visited pins
      uint32_t nranks = 0u, ncurs = 0u, npath[2] = {0u, 0u};
      uint32_t nvisb[2] = {0u, 0u};
#pragma unroll
      for (int k2 = 0; k2 < MAX_BW; ++k2) {
        if (k2 >= bw) continue;
        const uint32_t pk = (sel[k2] >> 4) & 0x3ffffu;  // parent rank, key
        uint32_t r = 0u;
#pragma unroll
        for (int k3 = 0; k3 < MAX_BW; ++k3)
          r += k3 < bw && ((sel[k3] >> 4) & 0x3ffffu) < pk;
        const int par = (int)(sel[k2] >> 2) & 3;
        const uint32_t jj = sel[k2] >> 22;
        nranks |= r << (2 * k2);
        ncurs |= jj << (8 * k2);
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int j = lane + 32 * s;
          const uint32_t pbyte = (path[s] >> (8 * par)) & 0xffu;
          const uint32_t byte =
              j <= step ? pbyte : (j == step + 1 ? jj : 0u);
          npath[s] |= byte << (8 * k2);
          nvisb[s] |= (((visb[s] >> par) & 1u) | (uint32_t)(j == (int)jj))
                      << k2;
        }
      }
      ranks = nranks;
      curs = ncurs;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        path[s] = npath[s];
        visb[s] = nvisb[s];
      }
    }

    // the route: the best beam by (cost, path rank), first wins
    int best = 0;
    float bc = cost[0];
    uint32_t br = ranks & 3u;
#pragma unroll
    for (int k = 1; k < MAX_BW; ++k) {
      const uint32_t rk = (ranks >> (2 * k)) & 3u;
      if (k < bw && (cost[k] < bc || (cost[k] == bc && rk < br))) {
        best = k;
        bc = cost[k];
        br = rk;
      }
    }
    // path position t = lane + 32 s: its pin, and the next position's
    float rx[2], ry[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int rl = (int)(path[s] >> (8 * best)) & 0xff;
      const float xl = __shfl_sync(FULL, x[0], rl & 31);
      const float xh = __shfl_sync(FULL, x[1], rl & 31);
      const float yl = __shfl_sync(FULL, y[0], rl & 31);
      const float yh = __shfl_sync(FULL, y[1], rl & 31);
      rx[s] = rl < 32 ? xl : xh;
      ry[s] = rl < 32 ? yl : yh;
    }
    const float wrap_x = __shfl_sync(FULL, rx[1], 0);
    const float wrap_y = __shfl_sync(FULL, ry[1], 0);
    const float down_x0 = __shfl_down_sync(FULL, rx[0], 1);
    const float down_y0 = __shfl_down_sync(FULL, ry[0], 1);
    const float rx2[2] = {lane == 31 ? wrap_x : down_x0,
                          __shfl_down_sync(FULL, rx[1], 1)};
    const float ry2[2] = {lane == 31 ? wrap_y : down_y0,
                          __shfl_down_sync(FULL, ry[1], 1)};
    float term[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int t = lane + 32 * s;
      const bool sv = t + 1 <= lim - 1;
      const float ddx = rx[s] - rx2[s], ddy = ry[s] - ry2[s];
      term[s] = sv ? sqrtf(ddx * ddx + ddy * ddy) : 0.f;
      if (t < M)
        segs[n * M + t] = sv ? pack_seg(rx[s], ry[s], rx2[s], ry2[s]) : NO_SEG;
    }
    // the wirelength, nets outer, positions inner
    for (int t = 0; t < rounds; ++t)
      wl += __shfl_sync(FULL, t < 32 ? term[0] : term[1], t & 31);
  }
  __syncwarp();

  // crossings of segments on different nets: segment a broadcast from
  // shared memory, the later nets' segments on the lanes' own slots
  // (N * M <= MAX_P: two)
  int own[2], own_net[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = lane + 32 * r;
    own[r] = i < N * M ? segs[i] : NO_SEG;
    own_net[r] = i / M;
  }
  int ints = 0;
  for (int na = 0; na + 1 < N; ++na) {
    for (int t = 0; t + 1 < M; ++t) {
      const int sa = segs[na * M + t];
      if (sa == NO_SEG) continue;
      const float ax1 = seg_coord(sa, 0), ay1 = seg_coord(sa, 1);
      const float ax2 = seg_coord(sa, 2), ay2 = seg_coord(sa, 3);
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (own[r] != NO_SEG && own_net[r] > na)
          ints += seg_intersect(ax1, ay1, ax2, ay2, seg_coord(own[r], 0),
                                seg_coord(own[r], 1), seg_coord(own[r], 2),
                                seg_coord(own[r], 3));
    }
  }
  wl_out = wl;
  ints_out = warp_sum(ints);
}

// The routed terminal reward of the kernel's reward type (reward_rows);
// "both" takes the route with fewer crossings, a tie goes to beam.
template <int K, bool GENERAL>
__device__ __forceinline__ float routed_reward(const FusedRolloutParams& p,
                                               const WarpBoard& b, int lane,
                                               int* segs) {
  float wl = 0.f, c_wl = 0.f;
  int ints = 0, c_ints = 0;
  if constexpr (K != K_BEAM) centroid_wl_int(p, b, lane, c_wl, c_ints);
  if constexpr (K != K_CENTROID && GENERAL)
    beam_wl_int_general(p, b, lane, segs, wl, ints);
  if constexpr (K != K_CENTROID && !GENERAL)
    beam_wl_int(p, b, lane, segs, wl, ints);
  if (K == K_CENTROID || (K == K_BOTH && ints > c_ints)) {
    wl = c_wl;
    ints = c_ints;
  }
  return -(p.lam_w * (wl / p.wl_norm) + p.lam_i * ((float)ints / p.int_norm));
}

// ---- in-kernel instance generator (generate) -----------------------------

// One net's pin -> component allocation, drawing call `call`: writes the
// component of each of the net's M ranks to comp_of[0..M) and, when the net
// is open, updates `space` (lane c: component c's free cells). Rank j is on
// lane j; WIDE (M up to 48) puts ranks 32.. on a second slot.
template <bool WIDE>
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
  int bin2 = 0;  // WIDE: rank lane + 32's
  if constexpr (WIDE) {
    const float ut2 = rng.uniform(call, M, lane + 32);
    for (int c = 0; c < C - 1; ++c)
      bin2 += ut2 > __shfl_sync(FULL, cw_cum, c) / tot_w;
  }
  int cnt = 0;
  for (int c = 0; c < C; ++c) {
    int got = __popc(__ballot_sync(FULL, lane < m && bin == c));
    if constexpr (WIDE)
      got += __popc(__ballot_sync(FULL, lane + 32 < m && bin2 == c));
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
  if constexpr (WIDE) {
    int slot2 = 0;
    for (int c = 0; c < C; ++c)
      slot2 += lane + 32 >= __shfl_sync(FULL, bound, c);
    const int comp2 = __shfl_sync(FULL, sidx, min(slot2, C - 1));
    if (lane + 32 < M) comp_of[lane + 32] = comp2;
  }
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
template <bool GENERAL>
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
    allocate_net<GENERAL>(p, rng, call_base + n,
                          __shfl_sync(FULL, net_count, n), k0, n < nn, space,
                          table + n * M, lane);

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
  // rank among the earlier pins of the same component (a ccount[comp]++
  // in pin order)
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
  planes_for<GENERAL>(p, b, __shfl_sync(FULL, b.ch, 0),
                      __shfl_sync(FULL, b.cw, 0), true, lane);
}

// ---- one step (body) -----------------------------------------------------

template <int K, bool GENERAL>
__device__ void step(const FusedRolloutParams& p, const Rng& rng,
                     WarpBoard& b, float& rsum, int& dcnt, int* table,
                     int* cells, int lane) {
  const int C = p.components, P = p.pins;
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
  int xx, yy;
  nth_cell<GENERAL>(p, even ? b.pl0 : b.pl1, (int)tin, lane, xx, yy);
  const bool alive = total > 0.0f;

  const int chc = comp_at(b.ch, b.cur, C), cwc = comp_at(b.cw, b.cur, C);
  if (alive) {
    paint<GENERAL>(p, b.grid, xx, yy, even ? chc : cwc, even ? cwc : chc,
                   lane);
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
  planes_for<GENERAL>(p, b, comp_at(b.ch, b.cur, C),
                      comp_at(b.cw, b.cur, C), !placed_all, lane);
  const int nt = plane_count(b.pl0) + plane_count(b.pl1);
  const bool done = placed_all || nt == 0 || !alive;
  if (!done) return;
  // routed reward on the post-placement tables, else the penalty
  const float reward =
      (placed_all && alive) ? routed_reward<K, GENERAL>(p, b, lane, table)
                            : p.penalty;
  rsum = rsum + reward;
  ++dcnt;
  generate<GENERAL>(p, rng, b, table, cells, lane);
}

// ---- the kernel ------------------------------------------------------------

template <int K, bool GENERAL>
__global__ void __launch_bounds__(BLOCK_THREADS,
                                  GENERAL ? MIN_BLOCKS_GENERAL : MIN_BLOCKS)
fused_rollout_warp_kernel(FusedRolloutParams p, FusedRolloutLeaves in,
                          FusedRolloutLeaves out, float* rsum_out,
                          int32_t* dcnt_out, int batch, int num_steps,
                          int block, uint32_t seed) {
  // the per-net allocation table, N x M entries (N * M is the pin table's
  // length), which the beam route reuses for its segments
  __shared__ int s_table[WARPS][GENERAL ? MAX_P : DEFAULT_N * DEFAULT_M];
  __shared__ int s_cells[WARPS][MAX_C * MAX_PPC];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bi = blockIdx.x * WARPS + warp;
  if (bi >= batch) return;  // the whole warp; no block barrier follows
  const int H = p.height, W = p.width, A = H * W, C = p.components;
  const int P = p.pins;
  const int64_t b = bi;

  WarpBoard bd;
  bd.grid = load_rows<GENERAL>(p, in.grid + b * A, lane);
  bd.pl0 = load_rows<GENERAL>(p, in.plane0 + b * A, lane);
  bd.pl1 = load_rows<GENERAL>(p, in.plane1 + b * A, lane);
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
    step<K, GENERAL>(p, rng, bd, rsum, dcnt, s_table[warp], s_cells[warp],
                     lane);
  }

  store_rows<GENERAL>(p, out.grid + b * A, bd.grid, lane);
  store_rows<GENERAL>(p, out.plane0 + b * A, bd.pl0, lane);
  store_rows<GENERAL>(p, out.plane1 + b * A, bd.pl1, lane);
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

template <int K>
int launch(const FusedRolloutParams& p, const FusedRolloutLeaves& in,
           const FusedRolloutLeaves& out, float* rsum, int32_t* dcnt,
           int batch, int num_steps, int block, uint32_t seed,
           cudaStream_t stream) {
  const int grid = (batch + WARPS - 1) / WARPS;
  if (p.general)
    fused_rollout_warp_kernel<K, true><<<grid, BLOCK_THREADS, 0, stream>>>(
        p, in, out, rsum, dcnt, batch, num_steps, block, seed);
  else
    fused_rollout_warp_kernel<K, false><<<grid, BLOCK_THREADS, 0, stream>>>(
        p, in, out, rsum, dcnt, batch, num_steps, block, seed);
  return (int)cudaGetLastError();
}

}  // namespace

int fused_rollout_warp_launch(const FusedRolloutParams& p,
                              const FusedRolloutLeaves& in,
                              const FusedRolloutLeaves& out, float* rsum,
                              int32_t* dcnt, int batch, int num_steps,
                              int block, uint32_t seed, cudaStream_t stream) {
  switch (p.kernel) {
    case K_CENTROID:
      return launch<K_CENTROID>(p, in, out, rsum, dcnt, batch, num_steps,
                                block, seed, stream);
    case K_BEAM:
      return launch<K_BEAM>(p, in, out, rsum, dcnt, batch, num_steps, block,
                            seed, stream);
    case K_BOTH:
      return launch<K_BOTH>(p, in, out, rsum, dcnt, batch, num_steps, block,
                            seed, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

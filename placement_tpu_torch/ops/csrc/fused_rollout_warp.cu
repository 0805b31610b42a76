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
//     The tables read at computed indices live in shared memory, a slice
//     per warp: the per-net allocation table, the cell order, and the
//     scratch of the episode end (below);
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
// of every net at once on two lane slots (beam_wl_int_general: nets of up
// to 16 pins on segments of a slot, of 17-32 one a slot, of more over both
// slots; a net's reductions a redux.sync each or a segment's shuffle tree;
// coordinates up to 254). All three general ones hold 64 registers like
// the default ones: their spills cost less than a second wave of boards.
// Both instantiations end an episode alike: the centroid route
// (centroid_wl_int) and the allocation (allocate_net) take a fixed number
// of warp steps whatever the nets, through a per-warp shared scratch:
// per-net sums and bin counts are shared-memory atomics of integers (exact
// in any order), the components' keys, spaces and bin edges are read back
// into registers, and the crossing pairs of the routed segments are dealt
// evenly over the lanes from shared memory.
// Every f32 sum whose order the plain version fixes is still taken in that
// order (the wirelength over pins, or over nets and path positions, the
// allocation's weights (as the integer sums they equal), the softmax total
// and cumulative probabilities, the per-board reward sum): lane 0's order,
// broadcast. Integer sums (and f32 sums of small integers, exact in any
// order) are warp reductions. Every sort is a rank by counting over unique
// keys, which gives the stable sort's order. The PRNG row and salt are
// those of the LOGICAL block, whatever the launch geometry. Build with
// -fmad=false, IEEE division and sqrt; the allocation's log, cos, exp and
// sqrt are taken in f64 and rounded to f32, as in the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_common.cuh"
#include "fused_warp.cuh"

namespace {

constexpr int WARPS = 8;                 // boards per block
constexpr int BLOCK_THREADS = 32 * WARPS;
constexpr int MIN_BLOCKS = 4;            // 64 registers a thread

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
  // (FLAT: a square footprint's second plane is the first)
  b.pl1 = FLAT && ch_c == cw_c
              ? b.pl0
              : free_row<false, FLAT>(p, b.grid, cw_c, ch_c, lane);
}

// ---- centroid routing reward (fused_routing.centroid_wl_int) -------------

// A warp's shared scratch of centroid_wl_int: per net its sums and
// its segments' far end, then the routed segments in pin order.
struct CentroidScratch {
  int count_x[MAX_N];              // pin count + x sum * 2^8
  int sum_y[MAX_N];                // y sum
  float4 end[MAX_N];               // far end (ex, ey), scaled (exs, eys)
  int info[MAX_N];                 // count | first pin << 8
  float4 seg[MAX_P];               // x1s, y1s, x2s, y2s (integer-scaled)
  float2 tag[MAX_P];               // scale, net
  float term[MAX_P];               // wirelength term
};
__shared__ CentroidScratch s_centroid[WARPS];
static_assert(MAX_M < 256, "a net's pin count in count_x's low byte");

// Centroid-route wirelength and crossing count of the board's pins (the
// same on every lane), for up to MAX_N nets and MAX_P pins in a fixed
// number of warp steps: a pin adds to its net's count and coordinate sums
// by two shared-memory atomics (integers: exact in any order); lane n makes
// net n's far end; each pin its segment and term, the routed ones packed in
// pin order; the wirelength is their f32 sum in pin order, and the
// V(V - 1) / 2 pairs of the V routed segments are dealt evenly over the
// lanes, both segments read from shared memory. The crossing predicate is
// symmetric in its two segments (each orientation test and the
// determinant's sign swap), so a pair's order within it does not matter.
__device__ void centroid_wl_int(const FusedRolloutParams& p,
                                const WarpBoard& b, int lane, float& wl_out,
                                int& ints_out) {
  CentroidScratch& cs = s_centroid[threadIdx.x >> 5];
  const int N = p.nets, P = p.pins;
  // a pin's net, or -1 where it is not routed
  int net_on[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int q = lane + 32 * s, n = b.pnet[s];
    net_on[s] = (q < P && q < b.npin && n >= 0 && n < N) ? n : -1;
  }
  __syncwarp();  // the last route's reads of the scratch are done
  if (lane < N) cs.count_x[lane] = cs.sum_y[lane] = 0;
  __syncwarp();
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    if (net_on[s] < 0) continue;
    atomicAdd(&cs.count_x[net_on[s]], 1 + 256 * b.pax[s]);
    atomicAdd(&cs.sum_y[net_on[s]], b.pay[s]);
  }
  __syncwarp();
  // lane n: net n's pin count (under 2^8), coordinate sums, centroid,
  // first pin
  const int cx_word = lane < N ? cs.count_x[lane] : 0;
  const int cnt = cx_word & 0xff;
  const int sxi = (cx_word - cnt) / 256, syi = lane < N ? cs.sum_y[lane] : 0;
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
  if (lane < N) {
    const bool two = cnt == 2;
    cs.end[lane] = make_float4(two ? x2 : cx, two ? y2 : cy, two ? x2 : sx,
                               two ? y2 : sy);
    cs.info[lane] = cnt | start << 8;
  }
  __syncwarp();
  // per pin: its segment (integer-scaled endpoints for the exact
  // predicate) and wirelength term, packed in pin order where routed
  const uint32_t below = (1u << lane) - 1u;
  int before = 0;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int q = lane + 32 * s, n = net_on[s];
    const float x = (float)b.pax[s], y = (float)b.pay[s];
    float4 e = make_float4(0.f, 0.f, 0.f, 0.f);
    float scv = 1.f;
    bool valid = false;
    if (n >= 0) {
      e = cs.end[n];
      const int info = cs.info[n], c_n = info & 0xff;
      const bool two = c_n == 2;
      scv = two ? 1.f : (float)max(c_n, 1);
      valid = !two || q - (info >> 8) == 0;
    }
    const uint32_t routed = __ballot_sync(FULL, valid);
    if (valid) {
      const int i = before + __popc(routed & below);
      const float dx = x - e.x, dy = y - e.y;
      cs.seg[i] = make_float4(x * scv, y * scv, e.z, e.w);
      cs.tag[i] = make_float2(scv, (float)n);
      cs.term[i] = sqrtf(dx * dx + dy * dy);
    }
    before += __popc(routed);
  }
  const int V = before;
  __syncwarp();
  // the wirelength in pin order (the pins without a term added +0 to it)
  float wl = 0.f;
  for (int i = 0; i < V; ++i) wl += cs.term[i];
  // crossings of routed segments on different nets: pair k is (i, i + d
  // mod V) with i = k mod V, d = k / V + 1, every unordered pair once
  const int pairs = V * (V - 1) / 2;
  int ints = 0;
  if (pairs > 0) {
    const int q32 = 32 / V, r32 = 32 - q32 * V;
    int d = lane / V + 1, i = lane - (d - 1) * V;
    for (int k = lane; k < pairs; k += 32) {
      const int j = i + d < V ? i + d : i + d - V;
      const float4 a = cs.seg[i], c = cs.seg[j];
      const float2 ta = cs.tag[i], tc = cs.tag[j];
      if (ta.y != tc.y)
        ints += seg_intersect(a.x * tc.x, a.y * tc.x, a.z * tc.x, a.w * tc.x,
                              c.x * ta.x, c.y * ta.x, c.z * ta.x, c.w * ta.x);
      i += r32;
      d += q32;
      if (i >= V) {
        i -= V;
        ++d;
      }
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

// The general beam route's lane layouts. A lane holds two positions, its
// slots 0 and 1, and every net of a board is routed at once:
//   * SEGMENTS (M <= 16 pins a net): a net on a segment of M lanes of one
//     slot, its pin rank j on lane base + j; G = 32 / M segments a slot,
//     net s G + g on segment g of slot s. The lanes past a slot's last
//     segment form a segment of no net. 2G >= N whenever N * M <= MAX_P.
//   * SLOTS (17-32 pins): net s on slot s, rank j on lane j (N <= 2).
//   * SPAN (more pins: one net): rank j on lane j % 32, slot j / 32.
enum BeamMode { SEGMENTS, SLOTS, SPAN };

constexpr bool all_nets_at_once(int m = 1) {
  return m > 16 || (2 * (32 / m) >= MAX_P / m && all_nets_at_once(m + 1));
}
static_assert(all_nets_at_once() && MAX_P / 17 <= 2 && MAX_P / 33 <= 1 &&
                  MAX_M <= 64,
              "every net of a board in one layout, a rank in 6 bits");

// A search key: a pin's squared distance from a beam's last pin, then its
// rank j (6 bits). Coordinates are integers up to 254, so the squared
// distance is an integer below 2^17 on which sqrt is strictly increasing
// and one-to-one in f32: the key's order is that of (the f32 distance, j),
// first wins. A pin the beam has visited (or no pin) keys after every
// distance, in rank order; a pin off the net, or taken, never wins.
constexpr uint32_t VISITED = 1u << 23;
constexpr uint32_t NO_KEY = ~0u;
static_assert(2 * 254 * 254 < (1 << 17), "a squared distance in 17 bits");

enum ReduceOp { R_MIN, R_MAX, R_ADD };

template <int OP>
__device__ __forceinline__ uint32_t reduce_op(uint32_t a, uint32_t b) {
  if constexpr (OP == R_MIN) return min(a, b);
  if constexpr (OP == R_MAX) return max(a, b);
  return a + b;
}

template <int OP>
__device__ __forceinline__ uint32_t warp_reduce(uint32_t v) {
  if constexpr (OP == R_MIN) return __reduce_min_sync(FULL, v);
  if constexpr (OP == R_MAX) return __reduce_max_sync(FULL, v);
  return __reduce_add_sync(FULL, v);
}

// Reduces each v[i][s] (i < n) over its slot's net, onto every lane of it.
// SPAN folds the two slots into one redux over the warp; SLOTS takes one
// redux a slot over the warp, the lanes past the net holding the
// identity; SEGMENTS a tree towards each segment's first lane (jl = lane -
// base), all values' trees side by side, then that lane's broadcast: a
// redux on a segment's lanes alone runs once for each segment.
template <int MODE, int OP, int K>
__device__ __forceinline__ void net_reduce(uint32_t (&v)[K][2], int n,
                                           int LM, int jl, int base) {
  if constexpr (MODE == SPAN) {
#pragma unroll
    for (int i = 0; i < K; ++i)
      if (i < n)
        v[i][0] = v[i][1] = warp_reduce<OP>(reduce_op<OP>(v[i][0], v[i][1]));
  } else if constexpr (MODE == SLOTS) {
#pragma unroll
    for (int i = 0; i < K; ++i)
#pragma unroll
      for (int s = 0; s < 2; ++s)
        if (i < n) v[i][s] = warp_reduce<OP>(v[i][s]);
  } else {
    for (int d = 1; d < LM; d <<= 1) {
      const bool in = jl + d < LM;
#pragma unroll
      for (int i = 0; i < K; ++i)
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          if (i >= n) continue;
          const uint32_t o = __shfl_down_sync(FULL, v[i][s], d);
          if (in) v[i][s] = reduce_op<OP>(v[i][s], o);
        }
    }
#pragma unroll
    for (int i = 0; i < K; ++i)
#pragma unroll
      for (int s = 0; s < 2; ++s)
        if (i < n) v[i][s] = __shfl_sync(FULL, v[i][s], base);
  }
}

// Slot s's v at pin rank r[s] of the slot's net (r[s] < M; it may differ
// from lane to lane): lane base + r[s] of slot s, or rank r[s] over both
// slots when the net spans them. SAME: r[0] == r[1] (a beam's last pin),
// read once.
template <int MODE, bool SAME>
__device__ __forceinline__ void pin_at(const int (&v)[2], const int (&r)[2],
                                       int base, int (&out)[2]) {
  if constexpr (MODE == SPAN) {
#pragma unroll
    for (int s = 0; s < (SAME ? 1 : 2); ++s) {
      const int lo = __shfl_sync(FULL, v[0], r[s] & 31);
      const int hi = __shfl_sync(FULL, v[1], r[s] & 31);
      out[s] = r[s] < 32 ? lo : hi;
    }
    if (SAME) out[1] = out[0];
  } else {
#pragma unroll
    for (int s = 0; s < 2; ++s) out[s] = __shfl_sync(FULL, v[s], base + r[s]);
  }
}

// 1 in each byte of v that is 0, else 0.
__device__ __forceinline__ uint32_t zero_bytes(uint32_t v) {
  const uint32_t t = (v & 0x7f7f7f7fu) + 0x7f7f7f7fu;
  return ~(t | v | 0x7f7f7f7fu) >> 7;
}

// The beam routes of every net of the board (see beam_wl_int_general):
// writes each net's segments to segs[n * M + t] and returns the
// wirelength. `pin` holds a pin's net + 1 (0 where it is not routed) and
// its coordinates, a byte each; lane n: net n's pin count and first pin.
//
// A net's beams are held on its lanes: cost, last pin (a byte each of
// `curs`) and path rank (2 bits each of `ranks`), uniform over the net;
// on rank j's position, byte k of `path` = beam k's pin at path position
// j, byte k of `visb` = 1 where beam k has visited (or has no) pin j. A
// round finds the c-th nearest untaken pin of every beam at once: for each
// c, one reduction (net_reduce) of the search keys per beam and slot, side
// by side. It then keeps the bw best candidates one after another, each
// the net's min of (cost, parent rank, pin key, parent k, c) as two
// reductions: the cost's bits, then, among the lanes that hold that cost,
// the rest in a word (rk << 26 | pin key << 10 | k << 8 | c << 6 | j). The
// pin's rank j last leaves the order as it is (the fields before it are
// unique already) and names the winner's lane. A new beam's path and
// visited pins are its parent's bytes, permuted.
template <int MODE>
__device__ float beam_nets(const FusedRolloutParams& p, const int (&pin)[2],
                           int cnt_l, int start_l, int lane, int* segs) {
  const int N = p.nets, M = p.pins_per_net, bw = p.beam_width;
  // lanes a segment, segments a slot, this lane's segment and first lane
  const int LM = MODE == SEGMENTS ? M : 32, G = 32 / LM, g = lane / LM;
  const int base = g * LM, jl = lane - base;

  // slot s: net n[s], its pin of rank j[s] (table position start + j)
  int n[2], j[2], lim[2], x[2], y[2];
  bool inseg[2], present[2];
  uint32_t sxy[1][2];
  float denom[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    n[s] = MODE == SPAN ? 0 : s * G + g;
    j[s] = MODE == SPAN ? lane + 32 * s : jl;
    const bool seg = g < G, net = seg && n[s] < N;
    inseg[s] = seg && j[s] < M;
    const int cnt_n = __shfl_sync(FULL, cnt_l, n[s] & 31);
    const int st = __shfl_sync(FULL, start_l, n[s] & 31);
    const int cnt = net ? cnt_n : 0;
    lim[s] = min(cnt, M);
    const int q = (net ? st : 0) + j[s];
    const int lo = __shfl_sync(FULL, pin[0], q & 31);
    const int hi = __shfl_sync(FULL, pin[1], q & 31);
    const int got = q < 32 ? lo : hi;
    const bool has = net && inseg[s] && q < 64 && (got >> 16) == n[s] + 1;
    x[s] = has ? (got >> 8) & 0xff : 0;
    y[s] = has ? got & 0xff : 0;
    present[s] = j[s] < lim[s];
    sxy[0][s] = present[s] ? (uint32_t)(x[s] << 16 | y[s]) : 0u;
    denom[s] = (float)max(cnt, 1);
  }

  // start: the pin farthest from the net centroid, first wins (coordinate
  // sums are small integers, exact in any order; x's and y's share a
  // word); a distance as its bits + 1, 0 where there is no pin
  net_reduce<MODE, R_ADD>(sxy, 1, LM, jl, base);
  uint32_t far[2], fmax[1][2], first[1][2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const float cx = (float)(sxy[0][s] >> 16) / denom[s];
    const float cy = (float)(sxy[0][s] & 0xffffu) / denom[s];
    const float ex = (float)x[s] - cx, ey = (float)y[s] - cy;
    far[s] = fmax[0][s] =
        present[s] ? __float_as_uint(sqrtf(ex * ex + ey * ey)) + 1u : 0u;
  }
  net_reduce<MODE, R_MAX>(fmax, 1, LM, jl, base);
#pragma unroll
  for (int s = 0; s < 2; ++s) first[0][s] = far[s] == fmax[0][s] ? j[s] : 63u;
  net_reduce<MODE, R_MIN>(first, 1, LM, jl, base);
  const uint32_t start[2] = {first[0][0], first[0][1]};

  float cost[2][MAX_BW];
  uint32_t curs[2], ranks[2], path[2], visb[2], kj[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int k = 0; k < MAX_BW; ++k) cost[s][k] = k == 0 ? 0.f : BIG;
    curs[s] = start[s] * 0x01010101u;
    ranks[s] = 0u;
    path[s] = j[s] == 0 ? start[s] * 0x01010101u : 0u;
    visb[s] = (j[s] == (int)start[s] || !present[s]) ? 0x01010101u : 0u;
    // the pin's key (the order of x * 32768 + y) and rank, in place
    kj[s] = (uint32_t)((x[s] + 1) << 8 | (y[s] + 1)) << 10 | (uint32_t)j[s];
  }
  const int rounds = (int)__reduce_max_sync(
      FULL, (unsigned)max(max(lim[0], lim[1]) - 1, 0));

  for (int step = 0; step < rounds; ++step) {
    const bool active[2] = {step + 1 <= lim[0] - 1, step + 1 <= lim[1] - 1};
    // each position's search key for each beam
    uint32_t dk[2][MAX_BW];
#pragma unroll
    for (int k = 0; k < MAX_BW; ++k) {
      dk[0][k] = dk[1][k] = NO_KEY;
      if (k >= bw) continue;
      const int cur[2] = {(int)(curs[0] >> (8 * k)) & 0xff,
                          (int)(curs[1] >> (8 * k)) & 0xff};
      int cx[2], cy[2];
      pin_at<MODE, true>(x, cur, base, cx);
      pin_at<MODE, true>(y, cur, base, cy);
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int dx = x[s] - cx[s], dy = y[s] - cy[s];
        const uint32_t d2 = (uint32_t)(dx * dx + dy * dy);
        if (inseg[s])
          dk[s][k] = ((visb[s] >> (8 * k)) & 1u ? VISITED : d2 << 6) |
                     (uint32_t)j[s];
      }
    }
    // candidates: the c-th nearest pin not taken yet of every beam at once;
    // bits 3k of cn[s]: 4 | c where this position is beam k's c-th
    uint32_t cn[2] = {0u, 0u};
    for (int c = 0; c < bw; ++c) {
      uint32_t m[MAX_BW][2];
#pragma unroll
      for (int k = 0; k < MAX_BW; ++k)
#pragma unroll
        for (int s = 0; s < 2; ++s)
          m[k][s] = (cn[s] >> (3 * k)) & 4u ? NO_KEY : dk[s][k];
      net_reduce<MODE, R_MIN>(m, bw, LM, jl, base);
#pragma unroll
      for (int k = 0; k < MAX_BW; ++k)
#pragma unroll
        for (int s = 0; s < 2; ++s)
          if (k < bw && m[k][s] != NO_KEY && m[k][s] == dk[s][k])
            cn[s] |= (4u | (uint32_t)c) << (3 * k);
    }
    // each position's candidate cost for each beam (NO_CAND where none): the
    // parent's cost plus the distance, BIG from a visited pin
    float cc[2][MAX_BW];
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int k = 0; k < MAX_BW; ++k) {
        cc[s][k] = NO_CAND;
        if (k >= bw || !((cn[s] >> (3 * k)) & 4u)) continue;
        const float d = dk[s][k] >= VISITED
                            ? BIG
                            : sqrtf((float)(dk[s][k] >> 6));
        const float ccost = cost[s][k] + d;
        cc[s][k] = ccost >= BIG ? BIG : ccost;
      }
    // keep the bw best: new beam k2 is the candidate of key rank k2;
    // sel[s][k2] = its key's low word
    uint32_t sel[2][MAX_BW];
#pragma unroll
    for (int k2 = 0; k2 < MAX_BW; ++k2) {
      sel[0][k2] = sel[1][k2] = 0u;
      if (k2 >= bw) continue;
      uint32_t hi[2], lo[2];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        float bc = NO_CAND;
#pragma unroll
        for (int k = 0; k < MAX_BW; ++k)
          if (k < bw) bc = fminf(bc, cc[s][k]);
        uint32_t low = ~0u;
#pragma unroll
        for (int k = 0; k < MAX_BW; ++k)
          if (k < bw && cc[s][k] == bc)
            low = min(low, ((ranks[s] >> (2 * k)) & 3u) << 26 |
                               (uint32_t)k << 8 |
                               ((cn[s] >> (3 * k)) & 3u) << 6);
        hi[s] = __float_as_uint(bc);
        lo[s] = low | kj[s];
      }
      uint32_t wh[1][2] = {{hi[0], hi[1]}};
      net_reduce<MODE, R_MIN>(wh, 1, LM, jl, base);
      uint32_t wlo[1][2] = {{hi[0] == wh[0][0] ? lo[0] : ~0u,
                             hi[1] == wh[0][1] ? lo[1] : ~0u}};
      net_reduce<MODE, R_MIN>(wlo, 1, LM, jl, base);
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int jj = (int)(wlo[0][s] & 63u), kp = (int)(wlo[0][s] >> 8) & 3;
#pragma unroll
        for (int k = 0; k < MAX_BW; ++k)
          if (j[s] == jj && k == kp) cc[s][k] = NO_CAND;
        sel[s][k2] = wlo[0][s];
        if (active[s]) cost[s][k2] = __uint_as_float(wh[0][s]);
      }
    }
    // the new beams' ranks, last pins, paths and visited pins: byte k2 of
    // `parent` = new beam k2's parent
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (!active[s]) continue;
      uint32_t parent = 0u, ncurs = 0u, nranks = 0u;
#pragma unroll
      for (int k2 = 0; k2 < MAX_BW; ++k2) {
        if (k2 >= bw) continue;
        const uint32_t pk = sel[s][k2] >> 10;  // parent rank, pin key
        uint32_t r = 0u;
#pragma unroll
        for (int k3 = 0; k3 < MAX_BW; ++k3)
          r += k3 < bw && (sel[s][k3] >> 10) < pk;
        nranks |= r << (2 * k2);
        parent |= ((sel[s][k2] >> 8) & 3u) << (4 * k2);
        ncurs |= (sel[s][k2] & 63u) << (8 * k2);
      }
      const uint32_t pbytes = __byte_perm(path[s], 0u, parent);
      path[s] = j[s] <= step ? pbytes : (j[s] == step + 1 ? ncurs : 0u);
      visb[s] = __byte_perm(visb[s], 0u, parent) |
                zero_bytes(ncurs ^ (uint32_t)j[s] * 0x01010101u);
      curs[s] = ncurs;
      ranks[s] = nranks;
    }
  }

  // the route: each net's best beam by (cost, path rank), first wins;
  // path position j[s]'s pin, and the next position's
  int rl[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    int best = 0;
    float bc = cost[s][0];
    uint32_t br = ranks[s] & 3u;
#pragma unroll
    for (int k = 1; k < MAX_BW; ++k) {
      const uint32_t rk = (ranks[s] >> (2 * k)) & 3u;
      if (k < bw && (cost[s][k] < bc || (cost[s][k] == bc && rk < br))) {
        best = k;
        bc = cost[s][k];
        br = rk;
      }
    }
    rl[s] = (int)(path[s] >> (8 * best)) & 0xff;
  }
  int rx[2], ry[2], rx2[2], ry2[2];
  pin_at<MODE, false>(x, rl, base, rx);
  pin_at<MODE, false>(y, rl, base, ry);
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    rx2[s] = __shfl_down_sync(FULL, rx[s], 1);
    ry2[s] = __shfl_down_sync(FULL, ry[s], 1);
  }
  if (MODE == SPAN) {  // position 31's next is slot 1's first
    const int wrap_x = __shfl_sync(FULL, rx[1], 0);
    const int wrap_y = __shfl_sync(FULL, ry[1], 0);
    if (lane == 31) {
      rx2[0] = wrap_x;
      ry2[0] = wrap_y;
    }
  }
  float term[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const bool sv = j[s] + 1 <= lim[s] - 1;
    const int ddx = rx[s] - rx2[s], ddy = ry[s] - ry2[s];
    term[s] = sv ? sqrtf((float)(ddx * ddx + ddy * ddy)) : 0.f;
    if (inseg[s] && n[s] < N)  // endpoints a byte each, as pack_seg
      segs[n[s] * M + j[s]] =
          sv ? rx[s] | ry[s] << 8 | rx2[s] << 16 | ry2[s] << 24 : NO_SEG;
  }
  // the wirelength, nets outer, positions inner (adding +0 past a net's
  // last segment is exact)
  float wl = 0.f;
  for (int u = 0, gu = 0; u < N; ++u, gu = gu + 1 == G ? 0 : gu + 1) {
    for (int t = 0; t < rounds; ++t) {  // net u: slot u / G, segment gu
      const bool hi = MODE == SPAN ? t >= 32 : u >= G;
      wl += __shfl_sync(FULL, hi ? term[1] : term[0], (gu * LM + t) & 31);
    }
  }
  return wl;
}

// beam_wl_int for nets of up to MAX_M pins and coordinates up to 254: the
// same search, tie rules and sums, every net at once (beam_nets), then the
// crossings.
__device__ void beam_wl_int_general(const FusedRolloutParams& p,
                                    const WarpBoard& b, int lane, int* segs,
                                    float& wl_out, int& ints_out) {
  const int N = p.nets, M = p.pins_per_net, P = p.pins;
  // a pin's net + 1 (0 where it is not routed) and its coordinates
  int pin[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int q = lane + 32 * s, n = b.pnet[s];
    const bool on = q < P && q < b.npin && n >= 0 && n < N;
    pin[s] = on ? (n + 1) << 16 | (b.pax[s] & 0xff) << 8 | (b.pay[s] & 0xff)
                : 0;
  }
  // lane n: net n's pin count and first pin
  int cnt_l = 0;
  for (int n = 0; n < N; ++n) {
    const int c = warp_sum(((pin[0] >> 16) == n + 1) +
                           ((pin[1] >> 16) == n + 1));
    if (lane == n) cnt_l = c;
  }
  const int start_l = warp_scan(cnt_l, lane, N) - cnt_l;
  __syncwarp();  // the generator's reads of the shared slice are done
  const float wl =
      M > 32   ? beam_nets<SPAN>(p, pin, cnt_l, start_l, lane, segs)
      : M > 16 ? beam_nets<SLOTS>(p, pin, cnt_l, start_l, lane, segs)
               : beam_nets<SEGMENTS>(p, pin, cnt_l, start_l, lane, segs);
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

// A warp's shared scratch of allocate_net: per component, and per
// position in the order by free space, the values every lane reads back.
struct AllocScratch {
  alignas(16) int key[MAX_C];     // component c: its sort key
  alignas(16) int space[MAX_C];   // position c: its component's free space
  alignas(16) float edge[MAX_C];  // position c: its bin's upper edge
  alignas(16) int bins[MAX_C];    // position c: the ranks its bin drew
  alignas(16) int order[MAX_C];   // position c: its component
};
__shared__ AllocScratch s_alloc[WARPS];
// extra_pins<true>'s count of the draws a net takes
__shared__ int s_net_draws[WARPS][MAX_N];

// The MAX_C entries of a shared table, in registers.
template <class T>
__device__ __forceinline__ void load_c(const T* from, T (&to)[MAX_C]) {
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) to[c] = from[c];
}

// One net's pin -> component allocation, drawing call `call`: writes the
// component of each of the net's M ranks to comp_of[0..M) and, when the net
// is open, updates `space` (lane c: component c's free cells). Rank j is on
// lane j % 32, slot j / 32; MAXM, the instantiation's most ranks a net,
// leaves out slot 1 where it is 32 or fewer. The values of the C <= MAX_C
// components (their keys, then by position their free space, bin edges and
// bins' counts) go through shared memory, and every lane works out the
// sort, the cumulative weights, the water-fill and the slots from them in
// registers. The cumulative weights are integer prefix sums (small
// integers, exact in f32 in any order); each bin's edge is one division on
// its own lane; the bins are counted by shared-memory atomics.
template <int MAXM>
__device__ void allocate_net(const FusedRolloutParams& p, const Rng& rng,
                             uint32_t call, int m, int k0, bool open,
                             int& space, int* comp_of, int lane) {
  AllocScratch& sh = s_alloc[threadIdx.x >> 5];
  const int C = p.components, M = p.pins_per_net;
  const bool cl = lane < C;
  // components by free space, descending: the keys space*(C+1)+(C-1-i)
  // are unique, so a component's position is the count of greater keys
  const int key = space * (C + 1) + (C - 1 - lane);
  if (cl) sh.key[lane] = key;
  __syncwarp();
  int v[MAX_C];
  load_c(sh.key, v);
  int pos = 0;
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) pos += c < C && v[c] > key;
  if (cl) {
    sh.order[pos] = lane;
    sh.space[pos] = space;
    sh.bins[lane] = 0;
  }
  __syncwarp();
  // by position: free space s, its running sum; the first k positions
  // share the ranks
  int s[MAX_C];
  load_c(sh.space, s);
  int run = 0, not_enough = 0;
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) {
    s[c] = c < C ? s[c] : 0;
    run += s[c];
    not_enough += c < C && run < m;
  }
  const int k = max(k0, min(not_enough + 1, C));
  // lane c: position c's cumulative weight (of positions 0..min(c, k - 1))
  // over the total, its bin's upper edge (the running sums once more:
  // selected by value, not kept in an array indexed at run time)
  const int mine = min(lane, k - 1);
  int cw = 0, tot = 0;
  run = 0;
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) {
    run += s[c];
    cw = c == mine ? run : cw;
    tot = c == k - 1 ? run : tot;
  }
  if (lane < MAX_C) sh.edge[lane] = (float)cw / fmaxf((float)tot, 1e-9f);
  __syncwarp();
  float edge[MAX_C];
  load_c(sh.edge, edge);
  // lane j: rank j's uniform and bin (wide: rank j + 32's too)
  const bool wide = MAXM > 32 && M > 32;
  const float ut = rng.uniform(call, M, lane);
  int bin = 0;
#pragma unroll
  for (int c = 0; c < MAX_C - 1; ++c) bin += c < C - 1 && ut > edge[c];
  if (lane < m) atomicAdd(&sh.bins[bin], 1);
  if (wide) {
    const float ut2 = rng.uniform(call, M, lane + 32);
    int bin2 = 0;
#pragma unroll
    for (int c = 0; c < MAX_C - 1; ++c) bin2 += c < C - 1 && ut2 > edge[c];
    if (lane + 32 < m) atomicAdd(&sh.bins[bin2], 1);
  }
  __syncwarp();
  // the positions' counts, then the in-order water-fill of the residue
  // into the remaining space, and where each position's ranks end
  int cnt[MAX_C];
  load_c(sh.bins, cnt);
  int resid = m;
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) {
    cnt[c] = c < C ? min(cnt[c], s[c]) : 0;
    resid -= cnt[c];
  }
  int before = 0, left = 0, bound[MAX_C];
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) {
    const int free_c = s[c] - cnt[c];
    cnt[c] += min(max(resid - before, 0), free_c);
    before += free_c;
    bound[c] = (c > 0 ? bound[c - 1] : 0) + cnt[c];
    left = c == pos ? s[c] - cnt[c] : left;
  }
  // the position that takes rank j: the count of positions whose ranks
  // end at or before j
  const auto position = [&](int j) {
    int slot = 0;
#pragma unroll
    for (int c = 0; c < MAX_C; ++c) slot += c < C && j >= bound[c];
    return sh.order[min(slot, C - 1)];
  };
  if (lane < M) comp_of[lane] = position(lane);
  if (wide && lane + 32 < M) comp_of[lane + 32] = position(lane + 32);
  if (open && cl) space = left;
}

// Lane n's extra pins when max_ppn > min_ppn (generate :407-450,
// allocate_pins_to_nets:1067): weights softmax(N(1/nn, 1/(net_distribution
// + 1))) from Box-Muller normals (draws 7 and 8), a multinomial of the
// `extra_total` extra pins (draw 9) capped at max_ppn - min_ppn per net,
// then an in-order water-fill of the residue. GENERAL: each net's share of
// the total is one division on its own lane, and the draws' nets are
// counted by shared-memory atomics.
template <bool GENERAL>
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
  if constexpr (GENERAL) {
    const float share = e / tot;
    for (int n = 0; n < N; ++n) {
      acc += __shfl_sync(FULL, share, n);
      if (lane == n) cprob = acc;
    }
  } else {
    for (int n = 0; n < N; ++n) {
      acc += __shfl_sync(FULL, e, n) / tot;
      if (lane == n) cprob = acc;
    }
  }
  // draw 9: element j on lane j % 32, binned and counted by ballot
  // (GENERAL: by shared-memory atomics)
  const int draws = min(extra_total, T);
  int cnt = 0;
  if constexpr (GENERAL) {
    int* counts = s_net_draws[threadIdx.x >> 5];
    if (lane < N) counts[lane] = 0;
    __syncwarp();
    for (int j0 = 0; j0 < draws; j0 += 32) {
      const int j = j0 + lane;
      const float ut = rng.uniform(9, T, j);
      int bin = 0;
      for (int c = 0; c < N - 1; ++c) bin += ut > __shfl_sync(FULL, cprob, c);
      if (j < draws) atomicAdd(&counts[bin], 1);
    }
    __syncwarp();
    cnt = lane < N ? counts[lane] : 0;
  } else {
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
    net_count +=
        extra_pins<GENERAL>(p, rng, nn, max(tp - p.ppn * nn, 0), lane);
    call_base = 10;
  }
  const int ncum = warp_scan(net_count, lane, N);
  const int num_pins = __shfl_sync(FULL, ncum, N - 1);
  b.npin = num_pins;

  int k0 = p.spatial ? (p.pin_spread * b.numc) / 10 + 1
                     : max(((p.pin_spread + 1) * b.numc) / 10, 1);
  k0 = min(k0, b.numc);
  __syncwarp();  // the last episode's reads of the tables are done
  for (int n = 0; n < N; ++n) {  // draws call_base .. call_base+N-1
    const int m = __shfl_sync(FULL, net_count, n);
    allocate_net<GENERAL ? MAX_M : DEFAULT_M>(p, rng, call_base + n, m, k0,
                                              n < nn, space, table + n * M,
                                              lane);
  }

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
__global__ void __launch_bounds__(BLOCK_THREADS, MIN_BLOCKS)
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

template <int K>
int boards_per_sm(bool general) {
  int blocks = 0;
  const cudaError_t err =
      general ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &blocks, fused_rollout_warp_kernel<K, true>,
                    BLOCK_THREADS, 0)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &blocks, fused_rollout_warp_kernel<K, false>,
                    BLOCK_THREADS, 0);
  return err == cudaSuccess ? blocks * WARPS : -1;
}

}  // namespace

int fused_rollout_warp_boards_per_sm(const FusedRolloutParams& p) {
  switch (p.kernel) {
    case K_CENTROID:
      return boards_per_sm<K_CENTROID>(p.general);
    case K_BEAM:
      return boards_per_sm<K_BEAM>(p.general);
    case K_BOTH:
      return boards_per_sm<K_BOTH>(p.general);
    default:
      return -1;
  }
}

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

// What the fused rollout's two kernel sources share: the C interface
// (parameters, leaf pointers), the fixed capacities, the specialisations,
// the counter-hash PRNG of the JAX kernel and the routing rewards' crossing
// predicate. Both sources run one warp per board (the general square four,
// on 8-lane segments); the row-mask helpers they share are fused_warp.cuh's.
//
//   fused_rollout.cu       the reduced kernels: K_SQUARE, K_RECT; the C
//                          entry points
//   fused_rollout_warp.cu  the pin kernels: K_CENTROID, K_BEAM, K_BOTH

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The capacities of the general instantiation of each kernel (T_GENERAL;
// the reduced kernels' GENERAL = true), which takes every configuration of
// the JAX kernel's envelope: a board as a row-major bit string over the
// warp's lanes (fused_warp.cuh's flat layout), so one side may pass 32
// where the area stays within MAX_AREA_LONG; nets and pins per net bounded
// by the pin table alone.
constexpr int MAX_H = 32;     // both sides <= 32 ...
constexpr int MAX_W = 32;
constexpr int MAX_AREA_LONG = 144;  // ... or the area <= 144
constexpr int MAX_C = 8;      // components
constexpr int MAX_N = 24;     // nets (2+ pins each)
constexpr int MAX_M = 48;     // pins per net
constexpr int MAX_P = 48;     // pin-table length
constexpr int MAX_PPC = 16;   // pins (cells) per component
constexpr int MAX_C_NOPIN = 64;  // components of SQUARE / RECT boards
constexpr int MAX_BW = 4;     // beam width
// The beam widths of the wide tier's second instantiation of the beam and
// "both" kernels (T_WIDE6): the Train page's widest beams, 5 and 6.
constexpr int WIDE6_BW = 6;
// The default instantiation (T_DEFAULT; GENERAL = false), the flagship's
// and every configuration's within these: a grid row per lane (sides <=
// 32), at most DEFAULT_N nets of DEFAULT_M pins.
constexpr int DEFAULT_N = 8;
constexpr int DEFAULT_M = 16;
// The wide instantiation of the pin kernels, for boards of many components
// (the web app's largest: 40 components, 100 pins, 5 x 5 footprints): the
// default one's grid row per lane, two components a lane, four pin slots a
// lane, and the per-net tables of the general one.
constexpr int WIDE_C = 64;    // components with pins
constexpr int WIDE_N = 24;    // nets
constexpr int WIDE_M = 48;    // pins per net
constexpr int WIDE_P = 128;   // pin-table length
constexpr int WIDE_PPC = 25;  // pins (cells) per component
// The wide tier's beam route lays the board's nets out on its four pin
// slots, two at a time: up to floor(32 / M) nets of M <= 32 pins a slot,
// two slots a net of more.
constexpr int WIDE_BEAM_SLOTS = 4;

// The lane slots that N nets of up to M >= 1 pins take in the beam route's
// layouts (fused_rollout_warp.cu, beam_nets).
__host__ __device__ constexpr int beam_slots(int N, int M) {
  return M > 32 ? N * ((M + 31) / 32) : (N + 32 / M - 1) / (32 / M);
}

// The pin kernels' instantiations (FusedRolloutParams::tier):
// fused_rollout_warp_kernel<K, TIER>. T_WIDE6 is T_WIDE's board and tables
// with a beam route of up to WIDE6_BW beams (K_BEAM and K_BOTH only).
enum Tier { T_DEFAULT = 0, T_GENERAL = 1, T_WIDE = 2, T_WIDE6 = 3 };

// The most beams the beam route of an instantiation holds.
__host__ __device__ constexpr int tier_beam_width(int tier) {
  return tier == T_WIDE6 ? WIDE6_BW : MAX_BW;
}

// The kernel's specialisations; KERNELS in fused_rollout.py names them.
enum Kernel { K_CENTROID = 0, K_BEAM = 1, K_BOTH = 2, K_SQUARE = 3,
              K_RECT = 4 };

static_assert(MAX_W <= 32, "a grid row must fit one 32-bit mask");
static_assert(MAX_H * MAX_W <= 32 * 32 && MAX_AREA_LONG <= 32 * 32,
              "a board's bit string must fit a warp's 32-bit words");
static_assert(MAX_AREA_LONG <= 255, "a route's coordinates must fit bytes");
static_assert(MAX_H * MAX_W <= (1 << 24), "cell counts must be exact in f32");
static_assert(MAX_P <= 64, "pin-table length");
static_assert(MAX_C * MAX_PPC <= 256, "per-component cell table size");
static_assert(DEFAULT_N <= MAX_N && DEFAULT_M <= MAX_M, "a narrower default");

}  // namespace

extern "C" {

// Mirrored by _KernelParams in placement_tpu_torch/ops/fused_rollout.py.
struct FusedRolloutParams {
  int32_t height, width;
  int32_t components, nets, pins_per_net, pins, pins_per_component;
  int32_t min_h, max_h, min_w, max_w;
  int32_t min_c, max_c, min_n, max_n;
  int32_t ppn;          // min pins per net
  int32_t max_ppn;      // max pins per net: > ppn runs extra_pins
  int32_t spatial;      // PIN_SPATIAL's k0 formula
  int32_t pin_spread;
  float lam_w, lam_i, wl_norm, int_norm, penalty;
  float net_div;        // net_distribution + 1
  int32_t kernel;       // enum Kernel
  int32_t beam_width;   // K_BEAM, K_BOTH
  int32_t component_n;  // K_SQUARE's n x n footprint
  int32_t tier;         // the pin kernels' instantiation (enum Tier)
  int32_t row_stride;   // the flat layout's bits a row (fused_warp.cuh)
  int32_t stride_recip; // ceil(2^22 / row_stride): t / row_stride
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

// The salt of board `bi`'s step `t` and its PRNG row: the LOGICAL block
// of make_fused_rollout's `block` argument, whatever the launch geometry.
__device__ __forceinline__ uint32_t block_salt(int bi, int block,
                                               uint32_t seed) {
  return seed ^ ((uint32_t)(bi / block) * 0x9e3779b9u);
}
__device__ __forceinline__ uint32_t step_salt(uint32_t blk_salt, int t) {
  return mix32(blk_salt ^ ((uint32_t)t * 0x85ebca6bu));
}

// Whether segments a and b cross or share an endpoint: the routing
// rewards' exact-integer crossing predicate (fused_routing._seg_intersect).
__device__ inline bool seg_intersect(float ax1, float ay1, float ax2,
                                     float ay2, float bx1, float by1,
                                     float bx2, float by2) {
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

}  // namespace

// The one-warp-per-board pin kernel of p.kernel (K_CENTROID, K_BEAM or
// K_BOTH; fused_rollout_warp.cu); returns cudaGetLastError() after the
// launch.
int fused_rollout_warp_launch(const FusedRolloutParams& p,
                              const FusedRolloutLeaves& in,
                              const FusedRolloutLeaves& out, float* rsum,
                              int32_t* dcnt, int batch, int num_steps,
                              int block, uint32_t seed, cudaStream_t stream);

// Boards of the pin kernel's instantiation that p selects one SM holds at
// once (the runtime's occupancy for its block), or -1 on an error.
int fused_rollout_warp_boards_per_sm(const FusedRolloutParams& p);

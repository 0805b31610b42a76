// A stand-in for <cuda_runtime.h> that lets g++ compile the port's .cu
// sources and run their kernels on the CPU, for tests on a machine without
// nvcc or a GPU. It is a test aid: nothing in the package loads a library
// built with it.
//
// What it emulates: the execution model the kernels rely on, not the card.
// emu_launch runs a launch one CUDA block and one warp at a time, in one OS
// thread. The 32 lanes of a warp are fibers (ucontext) that a round-robin
// scheduler resumes in lane order; every warp intrinsic is "publish my value,
// meet the lanes of my mask, read, meet again". A lane waits at a meeting
// until every lane named in its mask waits there with the same mask, so
// half-warp masks on diverged halves work, and a lane that names an exited
// or absent lane, or reads a lane outside its mask, aborts the run with a
// message instead of returning garbage. __shared__ arrays are `static`:
// blocks run one after another, so each block sees its own.
//
// Kernels may not use block-level barriers (__syncthreads): it is not
// defined here, so such a source fails to compile. atomicAdd is a plain
// read-modify-write: a lane runs alone until its next meeting, so no other
// lane comes between the read and the write.

#pragma once

#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <ucontext.h>

#include <algorithm>
#include <functional>
#include <type_traits>
#include <vector>

#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static

using std::max;
using std::min;

struct EmuDim3 {
  unsigned x = 0, y = 0, z = 0;
};
inline EmuDim3 threadIdx, blockIdx, blockDim, gridDim;

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
// occupancy is the card's: not emulated
template <class Kernel>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* blocks, Kernel, int, size_t) {
  *blocks = 0;
  return cudaErrorInvalidValue;
}

inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int __ffs(int v) { return __builtin_ffs(v); }
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const uint64_t v = (uint64_t)y << 32 | x;
  unsigned r = 0;
  for (int i = 0; i < 4; ++i)
    r |= (unsigned)(v >> (8 * ((s >> (4 * i)) & 7)) & 0xff) << (8 * i);
  return r;
}
struct alignas(8) float2 {
  float x, y;
};
struct alignas(16) float4 {
  float x, y, z, w;
};
struct alignas(16) int4 {
  int x, y, z, w;
};
struct alignas(16) uint4 {
  unsigned x, y, z, w;
};
struct alignas(8) uint2 {
  unsigned x, y;
};
inline float2 make_float2(float x, float y) { return {x, y}; }
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}
template <class T>
inline T atomicAdd(T* address, T v) {
  static_assert(std::is_integral<T>::value, "integer atomics");
  const T old = *address;
  *address = old + v;
  return old;
}
inline unsigned __float_as_uint(float f) {
  unsigned u;
  memcpy(&u, &f, 4);
  return u;
}
inline float __uint_as_float(unsigned u) {
  float f;
  memcpy(&f, &u, 4);
  return f;
}
inline int __float2int_rd(float x) { return (int)floorf(x); }

namespace emu {

constexpr int LANES = 32;
constexpr size_t STACK_BYTES = 256 * 1024;

struct Lane {
  ucontext_t ctx;
  bool live = false;      // has not returned from the kernel
  bool waiting = false;   // at a meeting
  unsigned mask = 0;      // the lanes it meets
  uint64_t slot = 0;      // its published value
};

struct Warp {
  ucontext_t sched;
  Lane lane[LANES];
  int cur = 0;            // the lane that runs
  unsigned tid0 = 0;      // threadIdx.x of lane 0
  std::function<void()> body;
};

inline Warp* g_warp = nullptr;

[[noreturn]] inline void fail(const char* what) {
  fprintf(stderr, "cuda_emu: %s (block %u, thread %u)\n", what, blockIdx.x,
          threadIdx.x);
  abort();
}

inline void trampoline() {
  Warp* w = g_warp;
  w->body();
  w->lane[w->cur].live = false;
  swapcontext(&w->lane[w->cur].ctx, &w->sched);
}

// Meets the lanes of `mask`; returns when all of them have arrived.
inline void meet(unsigned mask) {
  Warp* w = g_warp;
  Lane& me = w->lane[w->cur];
  if (!((mask >> w->cur) & 1u)) fail("a lane outside its own mask");
  me.waiting = true;
  me.mask = mask;
  swapcontext(&me.ctx, &w->sched);
}

// Runs the warp's lanes until all have returned.
inline void run_warp(Warp* w, int lanes) {
  static std::vector<char> stacks(LANES * STACK_BYTES);
  g_warp = w;
  for (int l = 0; l < LANES; ++l) {
    Lane& L = w->lane[l];
    L.live = l < lanes;
    L.waiting = false;
    if (!L.live) continue;
    getcontext(&L.ctx);
    L.ctx.uc_stack.ss_sp = stacks.data() + l * STACK_BYTES;
    L.ctx.uc_stack.ss_size = STACK_BYTES;
    L.ctx.uc_link = &w->sched;
    makecontext(&L.ctx, trampoline, 0);
  }
  for (;;) {
    bool any = false, ran = false;
    for (int l = 0; l < LANES; ++l) {
      Lane& L = w->lane[l];
      if (!L.live) continue;
      any = true;
      if (L.waiting) {
        bool all = true;
        for (int j = 0; j < LANES && all; ++j)
          if ((L.mask >> j) & 1u) {
            const Lane& o = w->lane[j];
            if (!o.live) fail("a mask names a lane that has exited");
            all = o.waiting && o.mask == L.mask;
          }
        if (!all) continue;
        for (int j = 0; j < LANES; ++j)
          if ((L.mask >> j) & 1u) w->lane[j].waiting = false;
      }
      w->cur = l;
      threadIdx.x = w->tid0 + l;
      swapcontext(&w->sched, &L.ctx);
      ran = true;
    }
    if (!any) return;
    if (!ran) fail("deadlock: lanes wait with masks that never meet");
  }
}

template <class T>
inline uint64_t to_bits(T v) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "4- or 8-byte values");
  uint64_t u = 0;
  memcpy(&u, &v, sizeof(T));
  return u;
}

template <class T>
inline T from_bits(uint64_t u) {
  T v;
  memcpy(&v, &u, sizeof(T));
  return v;
}

// Publishes `v`, meets, and returns lane `src`'s value (`src` < 0: none is
// read and the own value comes back).
template <class T>
inline T exchange(unsigned mask, T v, int src) {
  Warp* w = g_warp;
  const int me = w->cur;
  w->lane[me].slot = to_bits(v);
  meet(mask);
  T got = v;
  if (src >= 0) {
    if (!((mask >> src) & 1u)) fail("a shuffle reads a lane outside its mask");
    got = from_bits<T>(w->lane[src].slot);
  }
  meet(mask);
  return got;
}

// Publishes `v`, meets, and folds the values of the mask's lanes.
template <class F>
inline uint64_t gather(unsigned mask, uint64_t v, uint64_t init, F fold) {
  Warp* w = g_warp;
  w->lane[w->cur].slot = v;
  meet(mask);
  uint64_t acc = init;
  for (int j = 0; j < LANES; ++j)
    if ((mask >> j) & 1u) acc = fold(acc, w->lane[j].slot, j);
  meet(mask);
  return acc;
}

inline int lane_id() { return g_warp->cur; }

}  // namespace emu

template <class T>
inline T __shfl_sync(unsigned mask, T v, int src, int width = 32) {
  const int me = emu::lane_id();
  return emu::exchange(mask, v, (me & ~(width - 1)) | (src & (width - 1)));
}

template <class T>
inline T __shfl_up_sync(unsigned mask, T v, unsigned delta, int width = 32) {
  const int me = emu::lane_id(), in = me & (width - 1);
  return emu::exchange(mask, v, in >= (int)delta ? me - (int)delta : -1);
}

template <class T>
inline T __shfl_down_sync(unsigned mask, T v, unsigned delta,
                          int width = 32) {
  const int me = emu::lane_id(), in = me & (width - 1);
  return emu::exchange(mask, v,
                       in + (int)delta < width ? me + (int)delta : -1);
}

template <class T>
inline T __shfl_xor_sync(unsigned mask, T v, int lanemask, int width = 32) {
  const int me = emu::lane_id(), src = me ^ lanemask;
  return emu::exchange(mask, v,
                       (src & ~(width - 1)) == (me & ~(width - 1)) ? src : -1);
}

inline unsigned __ballot_sync(unsigned mask, bool pred) {
  return (unsigned)emu::gather(
      mask, pred, 0, [](uint64_t a, uint64_t v, int j) { return a | v << j; });
}

inline unsigned __reduce_add_sync(unsigned mask, unsigned v) {
  return (unsigned)emu::gather(
      mask, v, 0, [](uint64_t a, uint64_t o, int) { return a + o; });
}

inline unsigned __reduce_max_sync(unsigned mask, unsigned v) {
  return (unsigned)emu::gather(
      mask, v, 0, [](uint64_t a, uint64_t o, int) { return std::max(a, o); });
}

inline unsigned __reduce_min_sync(unsigned mask, unsigned v) {
  return (unsigned)emu::gather(
      mask, v, ~0ull, [](uint64_t a, uint64_t o, int) { return std::min(a, o); });
}

template <class T>
inline unsigned __match_any_sync(unsigned mask, T v) {
  const uint64_t mine = emu::to_bits(v);
  return (unsigned)emu::gather(
      mask, mine, 0, [mine](uint64_t a, uint64_t o, int j) {
        return a | (uint64_t)(o == mine) << j;
      });
}

inline void __syncwarp(unsigned mask = 0xffffffffu) { emu::meet(mask); }

// kernel<<<grid, threads, 0, stream>>>(args...) on the CPU: the blocks in
// turn, each block's warps in turn.
template <class Kernel, class... Args>
inline void emu_launch(Kernel kernel, int grid, int threads, Args... args) {
  static emu::Warp warp;
  blockDim.x = (unsigned)threads;
  gridDim.x = (unsigned)grid;
  for (int b = 0; b < grid; ++b) {
    blockIdx.x = (unsigned)b;
    for (int t0 = 0; t0 < threads; t0 += emu::LANES) {
      warp.tid0 = (unsigned)t0;
      warp.body = [&] { kernel(args...); };
      emu::run_warp(&warp, std::min(emu::LANES, threads - t0));
    }
  }
}

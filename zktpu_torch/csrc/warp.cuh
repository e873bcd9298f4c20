// A group of G cooperating lanes (G a power of two, at most 32): what the
// kernels that spread one piece of work over the lanes of a warp share
// (coop381.cuh's Fq arithmetic, transcript.cuh's round step and Keccak,
// compact.cuh's look-back).
//
// Built with nvcc, a group is the first G lanes of a warp and its exchanges are
// warp shuffles and votes. Built with a host C++ compiler (as the CPU tests
// do), a group is G fibers of one host thread (run_lanes) that hand over to one
// another at a barrier for each shuffle and vote, so the same code runs against
// the plain versions without a card, and stays fast when the host's cores are
// busy (host threads at a spin barrier took minutes then).

#pragma once

#include <cstdint>

#ifndef __CUDACC__
#include <ucontext.h>

#include <vector>
#endif

#ifdef __CUDACC__
#define WP_FN __device__ __forceinline__
#else
#define WP_FN inline
#endif

namespace warp {

#ifdef __CUDACC__

template <int G>
struct Group {
  static constexpr uint32_t kMask = G == 32 ? 0xffffffffu : (1u << G) - 1u;
  uint32_t lane;
  __device__ __forceinline__ uint32_t shfl(uint32_t v, uint32_t src) const {
    return __shfl_sync(kMask, v, (int)src, G);
  }
  __device__ __forceinline__ uint32_t ballot(bool pred) const {
    return __ballot_sync(kMask, pred) & kMask;
  }
};

#else  // host: G fibers and a barrier

struct Exchange {
  int size = 0;
  uint32_t slot[32] = {};
  ucontext_t* fibers = nullptr;  // the lanes' contexts
  int current = 0;               // the lane that runs
  // hand over to the next lane; the last hands back to the first, by when
  // every lane has reached the barrier
  void sync() {
    const int me = current;
    current = (me + 1) % size;
    swapcontext(&fibers[me], &fibers[current]);
  }
};

template <int G>
struct Group {
  static constexpr uint32_t kMask = G == 32 ? 0xffffffffu : (1u << G) - 1u;
  uint32_t lane;
  Exchange* ex;
  uint32_t shfl(uint32_t v, uint32_t src) const {
    if (G == 1) return v;
    ex->slot[lane] = v;
    ex->sync();
    const uint32_t r = ex->slot[src & (G - 1)];
    ex->sync();
    return r;
  }
  uint32_t ballot(bool pred) const {
    if (G == 1) return pred ? 1u : 0u;
    ex->slot[lane] = pred ? 1u : 0u;
    ex->sync();
    uint32_t mask = 0;
    for (int l = 0; l < G; ++l) mask |= ex->slot[l] << l;
    ex->sync();
    return mask;
  }
};

template <int G, class Body>
struct LaneStart {
  const Body* body;
  Exchange* ex;
};

template <int G, class Body>
void lane_main(uint32_t lo, uint32_t hi, uint32_t lane) {
  const auto* start =
      reinterpret_cast<const LaneStart<G, Body>*>((uintptr_t)hi << 32 | (uintptr_t)lo);
  (*start->body)(Group<G>{lane, start->ex});
}

// body(Group<G>) on each of G lanes, fibers of this thread: each lane runs
// until it meets a barrier and hands over to the next, and a lane that ends
// hands over to the next too, the last back to the caller (every lane meets
// the same barriers, as a warp's do)
template <int G, class Body>
void run_lanes(const Body& body) {
  constexpr size_t kStack = 256 * 1024;
  Exchange ex;
  ex.size = G;
  ucontext_t done, fibers[G];
  std::vector<char> stacks(G * kStack);
  ex.fibers = fibers;
  const LaneStart<G, Body> start{&body, &ex};
  const uintptr_t at = reinterpret_cast<uintptr_t>(&start);
  for (int lane = 0; lane < G; ++lane) {
    getcontext(&fibers[lane]);
    fibers[lane].uc_stack.ss_sp = stacks.data() + lane * kStack;
    fibers[lane].uc_stack.ss_size = kStack;
    fibers[lane].uc_link = lane + 1 < G ? &fibers[lane + 1] : &done;
    makecontext(&fibers[lane], reinterpret_cast<void (*)()>(&lane_main<G, Body>), 3,
                (uint32_t)at, (uint32_t)(at >> 32), (uint32_t)lane);
  }
  swapcontext(&done, &fibers[0]);
}

#endif

// a 64-bit value from lane src (two 32-bit shuffles)
template <class Gr>
WP_FN uint64_t shfl64(const Gr& g, uint64_t v, uint32_t src) {
  const uint32_t lo = g.shfl((uint32_t)v, src);
  const uint32_t hi = g.shfl((uint32_t)(v >> 32), src);
  return lo | (uint64_t)hi << 32;
}

// the highest set bit of a non-zero mask
WP_FN int top_bit(uint32_t mask) {
#ifdef __CUDACC__
  return 31 - __clz(mask);
#else
  return 31 - __builtin_clz(mask);
#endif
}

}  // namespace warp

// Keccak-f[1600] on 25 uint64 lanes: the permutation under both transcript
// kernels of transcript_kernels.cu (keccak_f and round_step).
//
// Lane j = 5 y + x is the sponge's byte offset 8 j, the order of
// zktpu_torch/hash/keccak_device.py (there each lane is an int64 holding the
// same 64 bits).
//
// `permute` holds the state in one thread's registers and unrolls all 24
// rounds: every index, rotation and round constant is a constant, so the
// constants are immediates and pi's renaming of the lanes is a renaming of
// registers, not moves (a rolled round loop has to move b into a at its back
// edge). A rotation by 0 is the lane itself: nothing shifts by 64.
//
// `permute_lanes` spreads the state over 25 lanes of a group of 32 (warp.cuh),
// lane j holding state lane j: theta's column parities and D come by
// shuffles, rho is a funnel shift by the lane's own amount, pi one shuffle
// from the source lane, chi two shuffles, iota on lane 0. Lanes 25-31 take
// part in the shuffles and hold nothing.
//
// Built with nvcc the functions are device code; built with a host C++ compiler
// (tests/test_torch_transcript_kernels.py does) the same code runs on the host.

#pragma once

#include <cstdint>

#include "warp.cuh"

#ifdef __CUDACC__
#define KC_FN __device__ __forceinline__
#else
#define KC_FN inline
#endif

namespace keccak {

constexpr int kLanes = 25;
constexpr int kRounds = 24;
// the 136-byte rate of Keccak-256, in lanes
constexpr int kRateLanes = 17;

KC_FN constexpr uint64_t round_constant(int round) {
  switch (round) {
    case 0: return 0x0000000000000001ull;
    case 1: return 0x0000000000008082ull;
    case 2: return 0x800000000000808Aull;
    case 3: return 0x8000000080008000ull;
    case 4: return 0x000000000000808Bull;
    case 5: return 0x0000000080000001ull;
    case 6: return 0x8000000080008081ull;
    case 7: return 0x8000000000008009ull;
    case 8: return 0x000000000000008Aull;
    case 9: return 0x0000000000000088ull;
    case 10: return 0x0000000080008009ull;
    case 11: return 0x000000008000000Aull;
    case 12: return 0x000000008000808Bull;
    case 13: return 0x800000000000008Bull;
    case 14: return 0x8000000000008089ull;
    case 15: return 0x8000000000008003ull;
    case 16: return 0x8000000000008002ull;
    case 17: return 0x8000000000000080ull;
    case 18: return 0x000000000000800Aull;
    case 19: return 0x800000008000000Aull;
    case 20: return 0x8000000080008081ull;
    case 21: return 0x8000000000008080ull;
    case 22: return 0x0000000080000001ull;
    default: return 0x8000000080008008ull;
  }
}

template <int R>
KC_FN uint64_t rotl(uint64_t x) {
  if constexpr (R == 0) {
    return x;
  } else {
    return (x << R) | (x >> (64 - R));
  }
}

// theta, rho, pi, chi and iota, 24 times, unrolled
KC_FN void permute(uint64_t (&a)[kLanes]) {
#pragma unroll
  for (int round = 0; round < kRounds; ++round) {
    // theta: each lane takes the parities of its two neighbouring columns
    uint64_t c[5], d[5];
#pragma unroll
    for (int x = 0; x < 5; ++x) c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
#pragma unroll
    for (int x = 0; x < 5; ++x) d[x] = c[(x + 4) % 5] ^ rotl<1>(c[(x + 1) % 5]);
#pragma unroll
    for (int j = 0; j < kLanes; ++j) a[j] ^= d[j % 5];
    // rho and pi: b[y + 5 ((2 x + 3 y) % 5)] = rotl(a[x + 5 y], r[x][y])
    uint64_t b[kLanes];
    b[0] = rotl<0>(a[0]);
    b[1] = rotl<44>(a[6]);
    b[2] = rotl<43>(a[12]);
    b[3] = rotl<21>(a[18]);
    b[4] = rotl<14>(a[24]);
    b[5] = rotl<28>(a[3]);
    b[6] = rotl<20>(a[9]);
    b[7] = rotl<3>(a[10]);
    b[8] = rotl<45>(a[16]);
    b[9] = rotl<61>(a[22]);
    b[10] = rotl<1>(a[1]);
    b[11] = rotl<6>(a[7]);
    b[12] = rotl<25>(a[13]);
    b[13] = rotl<8>(a[19]);
    b[14] = rotl<18>(a[20]);
    b[15] = rotl<27>(a[4]);
    b[16] = rotl<36>(a[5]);
    b[17] = rotl<10>(a[11]);
    b[18] = rotl<15>(a[17]);
    b[19] = rotl<56>(a[23]);
    b[20] = rotl<62>(a[2]);
    b[21] = rotl<55>(a[8]);
    b[22] = rotl<39>(a[14]);
    b[23] = rotl<41>(a[15]);
    b[24] = rotl<2>(a[21]);
    // chi, row by row
#pragma unroll
    for (int y = 0; y < 25; y += 5) {
#pragma unroll
      for (int x = 0; x < 5; ++x) a[y + x] = b[y + x] ^ (~b[y + (x + 1) % 5] & b[y + (x + 2) % 5]);
    }
    // iota
    a[0] ^= round_constant(round);
  }
}

// ----------------------------------------------------------------------
// the state on 25 lanes of a group of 32
// ----------------------------------------------------------------------

// rho's rotation of lane j = x + 5 y, r[x][y], six bits a lane, ten lanes a word
// lanes 0-9: 0 1 62 28 27 36 44 6 55 20
constexpr uint64_t kRho0 = 0ull | 1ull << 6 | 62ull << 12 | 28ull << 18 | 27ull << 24 |
                           36ull << 30 | 44ull << 36 | 6ull << 42 | 55ull << 48 | 20ull << 54;
// lanes 10-19: 3 10 43 25 39 41 45 15 21 8
constexpr uint64_t kRho1 = 3ull | 10ull << 6 | 43ull << 12 | 25ull << 18 | 39ull << 24 |
                           41ull << 30 | 45ull << 36 | 15ull << 42 | 21ull << 48 | 8ull << 54;
// lanes 20-24: 18 2 61 56 14
constexpr uint64_t kRho2 = 18ull | 2ull << 6 | 61ull << 12 | 56ull << 18 | 14ull << 24;

KC_FN uint32_t funnel_left(uint32_t lo, uint32_t hi, uint32_t s) {
#ifdef __CUDACC__
  return __funnelshift_l(lo, hi, s);
#else
  s &= 31;
  return s == 0 ? hi : (hi << s) | (lo >> (32 - s));
#endif
}

// What lane j does in every round: its rotation (a swap of the halves for 32
// and more, then a funnel shift), the lane pi takes its value from, and the
// lanes theta and chi read.
struct LaneRoles {
  uint32_t swap, shift;
  uint32_t pi_src;
  uint32_t col[4];      // the other lanes of its column, x + 5 y'
  uint32_t west, east;  // a lane of column x - 1 and of column x + 1
  uint32_t chi1, chi2;  // x + 1 and x + 2 in its row
  bool first;           // lane 0: iota
};

KC_FN LaneRoles lane_roles(uint32_t j) {
  LaneRoles r;
  const uint32_t lane = j < kLanes ? j : 0;
  const uint32_t x = lane % 5, y = lane / 5;
  const uint64_t word = lane < 10 ? kRho0 : lane < 20 ? kRho1 : kRho2;
  const uint32_t rot = (uint32_t)(word >> (6 * (lane % 10))) & 63u;
  r.swap = rot >> 5;
  r.shift = rot & 31u;
  // pi: lane x2 + 5 y2 takes lane 5 x2 + (x2 + 3 y2) % 5
  r.pi_src = 5 * x + (x + 3 * y) % 5;
#pragma unroll
  for (int q = 0; q < 4; ++q) r.col[q] = x + 5 * ((y + 1 + q) % 5);
  r.west = (x + 4) % 5;
  r.east = (x + 1) % 5;
  r.chi1 = 5 * y + (x + 1) % 5;
  r.chi2 = 5 * y + (x + 2) % 5;
  r.first = j == 0;
  return r;
}

template <class Gr>
KC_FN void permute_lanes(const Gr& g, const LaneRoles& r, uint64_t& a) {
#pragma unroll
  for (int round = 0; round < kRounds; ++round) {
    // theta
    uint64_t c = a;
#pragma unroll
    for (int q = 0; q < 4; ++q) c ^= warp::shfl64(g, a, r.col[q]);
    const uint64_t west = warp::shfl64(g, c, r.west);
    const uint64_t east = warp::shfl64(g, c, r.east);
    a ^= west ^ rotl<1>(east);
    // rho
    uint32_t lo = (uint32_t)a, hi = (uint32_t)(a >> 32);
    if (r.swap) {
      const uint32_t t = lo;
      lo = hi;
      hi = t;
    }
    a = funnel_left(hi, lo, r.shift) | (uint64_t)funnel_left(lo, hi, r.shift) << 32;
    // pi
    const uint64_t b = warp::shfl64(g, a, r.pi_src);
    // chi
    const uint64_t b1 = warp::shfl64(g, b, r.chi1);
    const uint64_t b2 = warp::shfl64(g, b, r.chi2);
    a = b ^ (~b1 & b2);
    // iota
    if (r.first) a ^= round_constant(round);
  }
}

}  // namespace keccak

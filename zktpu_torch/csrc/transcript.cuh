// The work of round_step (transcript_kernels.cu): one round of a fused prover's
// Fiat-Shamir transcript, from a summing kernel's lazy rows to the next
// challenge, on keccak.cuh's permutation and mont.cuh's 8-word arithmetic.
//
// Steps, in the order of the eager chain it replaces (zktpu/sumcheck/fused.py
// _device_prove and zktpu/gkr/fused_lazy.py _big_round):
//   1. canonical values: a lazy row is W + 1 words, the exact integer sum S =
//      lo + hi 2^(32 W) of Montgomery entries; its value is S / R = lo / R + hi
//      mod p, that is mul(1, lo) + hi. lo may be anything below 2^(32 W), so it
//      is mul's second operand (mont.cuh: the first must be below p); hi is
//      below 2^32 < p.
//   2. for k = 3 (GKR), the values y_0, y_1, y_2 at t = 0, 1, 2 become the
//      coefficients c0 = y_0, c2 = (y_0 + y_2 - 2 y_1) / 2 (a product by 1/2 in
//      Montgomery form), c1 = y_1 - y_0 - c2, and the absorbed length m is the
//      trimmed one: the highest non-zero coefficient's index plus one (zktpu's
//      interpolate trims trailing zeros; an all-ADD layer makes c2 vanish).
//      For k = 2 (plain sumcheck) both half-sums are absorbed: m = 2.
//   3. the absorb: content = prefix || the m elements (32 bytes, 4 lanes,
//      each), padded 0x01 .. 0x80 over the blocks it needs, xored into the
//      state block by block, a permutation a block. A steady round's prefix is
//      the last digest (4 lanes) and its state is fresh (zero); the first round
//      of a proof or phase continues the host's sponge, whose pending tail
//      (under 136 bytes, whole lanes) is the prefix, so the content takes one
//      block or two, as m decides.
//   4. the next challenge: the digest (the state's first 4 lanes, a 256-bit
//      integer, possibly at or above p) times R^2 mod p, mul(r2, digest): the
//      Montgomery form of the digest reduced mod p.
// Every value stays canonical (mont.cuh's contract).

#pragma once

#include <cstdint>

#include "keccak.cuh"
#include "mont.cuh"
#include "warp.cuh"

namespace transcript {

constexpr int W = 8;
constexpr int kMaxElems = 3;
// a pending tail is under one block: at most 16 whole lanes
constexpr int kMaxPrefixLanes = keccak::kRateLanes - 1;
constexpr uint64_t kTopBit = 1ull << 63;

// What a launch takes by value: the field (p, n0), R^2 mod p and 1/2 in
// Montgomery form, canonical words.
struct Consts {
  mont::Modulus<W> M;
  uint32_t r2[W];
  uint32_t inv2[W];
};

// A lazy row of W + 1 words -> its canonical value.
MT_FN void canonical(uint32_t (&out)[W], const uint32_t* row, const mont::Modulus<W>& M) {
  uint32_t lo[W], one[W], hi[W];
#pragma unroll
  for (int j = 0; j < W; ++j) {
    lo[j] = row[j];
    one[j] = j == 0;
    hi[j] = j == 0 ? row[W] : 0;
  }
  mont::mul<W>(out, one, lo, M);
  mont::add<W>(out, out, hi, M);
}

// y_0, y_1, y_2 -> c0, c1, c2 in place; returns the trimmed length (0..3).
MT_FN int interpolate(uint32_t (&e)[kMaxElems][W], const Consts& C) {
  uint32_t t[W], c1[W], c2[W];
  mont::add<W>(t, e[0], e[2], C.M);
  mont::sub<W>(t, t, e[1], C.M);
  mont::sub<W>(t, t, e[1], C.M);
  mont::mul<W>(c2, C.inv2, t, C.M);
  mont::sub<W>(c1, e[1], e[0], C.M);
  mont::sub<W>(c1, c1, c2, C.M);
  uint32_t any[kMaxElems] = {0, 0, 0};
#pragma unroll
  for (int j = 0; j < W; ++j) {
    e[1][j] = c1[j];
    e[2][j] = c2[j];
    any[0] |= e[0][j];
    any[1] |= c1[j];
    any[2] |= c2[j];
  }
  return any[2] ? 3 : any[1] ? 2 : any[0] ? 1 : 0;
}

// One round on a group of 32 lanes (a warp; warp.cuh). rows: (K, W + 1) lazy
// words, K = 2 or 3. A steady round (First false) absorbs the last digest,
// `prefix`'s 4 lanes, || the elements into a fresh state; the first round of a
// proof or phase continues state_in's 25 lanes after the host's pending tail,
// `prefix`'s prefix_lanes (at most 16) lanes. Writes the canonical rows (K, W)
// (coefficients for K = 3, untrimmed: the trimmed ones are zero), the new
// state's 25 lanes and the next challenge (W words, Montgomery form).
//
// Every array index is a constant. The lanes split the work that does not
// depend on itself: lane i < K takes row i's canonical value (a product), the
// K values are shuffled to every lane, which interpolates and trims them (the
// same instructions on every lane cost no more than on one); lane r < 4 K
// holds the elements' r-th word pair and stores it, and lane t builds
// absorbed lane t of each block (a prefix lane it loaded, a word pair shuffled
// from lane t - prefix, or the pad bits). The permutation runs on 25 of the
// lanes, a state lane each (keccak.cuh's permute_lanes); the digest's four
// lanes are shuffled to every lane for the challenge's product. (The
// unrolled one-thread permutation on every lane, the state in each lane's
// registers, was slower: PERF.md.)
template <int K, bool First, class Gr>
MT_FN void round_step(const Gr& g, const uint32_t* rows, const uint64_t* state_in,
                      const uint64_t* prefix, int prefix_lanes, const Consts& C,
                      uint32_t* out_rows, uint64_t* state_out, uint32_t* challenge) {
  static_assert(K == 2 || K == 3, "a round has 2 or 3 rows");
  constexpr int R = keccak::kRateLanes;
  const int lane = (int)g.lane;
  const int P = First ? prefix_lanes : W / 2;
  const uint64_t pre = lane < P ? prefix[lane] : 0;
  uint32_t y[W];
  canonical(y, rows + (lane < K ? lane : 0) * (W + 1), C.M);
  uint32_t e[kMaxElems][W];
#pragma unroll
  for (int i = 0; i < kMaxElems; ++i) {
#pragma unroll
    for (int j = 0; j < W; ++j) e[i][j] = i < K ? g.shfl(y[j], i) : 0;
  }
  int m = K;
  if constexpr (K == 3) m = interpolate(e, C);
  uint64_t pair = 0;
#pragma unroll
  for (int q = 0; q < K; ++q) {
#pragma unroll
    for (int l = 0; l < W / 2; ++l) {
      if (lane == (W / 2) * q + l) pair = e[q][2 * l] | (uint64_t)e[q][2 * l + 1] << 32;
    }
  }
  if (lane < (W / 2) * K) {
    out_rows[2 * lane] = (uint32_t)pair;
    out_rows[2 * lane + 1] = (uint32_t)(pair >> 32);
  }
  // absorbed lanes `lane` (block 0) and R + lane (block 1)
  const int used = P + (W / 2) * m;
  const int blocks = First ? used / R + 1 : 1;
  const int last = R * blocks - 1;
  const uint64_t from0 = warp::shfl64(g, pair, (uint32_t)(lane - P) & 31u);
  uint64_t c0 = lane < P ? pre : lane < used ? from0 : 0;
  c0 ^= (lane == used ? 0x01ull : 0ull) ^ (lane == last ? kTopBit : 0ull);
  uint64_t c1 = 0;
  if constexpr (First) {
    const uint64_t from1 = warp::shfl64(g, pair, (uint32_t)(R + lane - P) & 31u);
    c1 = R + lane < used ? from1 : 0;
    c1 ^= (R + lane == used ? 0x01ull : 0ull) ^ (R + lane == last ? kTopBit : 0ull);
  }
  const keccak::LaneRoles roles = keccak::lane_roles(g.lane);
  uint64_t a = First && lane < keccak::kLanes ? state_in[lane] : 0;
#pragma unroll 1
  for (int b = 0; b < blocks; ++b) {
    a ^= lane < R ? (b == 0 ? c0 : c1) : 0;
    keccak::permute_lanes(g, roles, a);
  }
  uint64_t d[W / 2];
#pragma unroll
  for (int l = 0; l < W / 2; ++l) d[l] = warp::shfl64(g, a, l);
  if (lane < keccak::kLanes) state_out[lane] = a;
  uint32_t dw[W], r[W];
#pragma unroll
  for (int l = 0; l < W / 2; ++l) {
    dw[2 * l] = (uint32_t)d[l];
    dw[2 * l + 1] = (uint32_t)(d[l] >> 32);
  }
  mont::mul<W>(r, C.r2, dw, C.M);
  uint32_t word = 0;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    if (lane == j) word = r[j];
  }
  if (lane < W) challenge[lane] = word;
}

}  // namespace transcript

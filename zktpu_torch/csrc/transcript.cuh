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

namespace transcript {

constexpr int W = 8;
constexpr int kMaxElems = 3;
// a pending tail is under one block: at most 16 whole lanes
constexpr int kMaxPrefixLanes = keccak::kRateLanes - 1;
// prefix + elements: at most 16 + 12 lanes, two blocks
constexpr int kMaxBlocks = 2;
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
#pragma unroll
  for (int j = 0; j < W; ++j) {
    e[1][j] = c1[j];
    e[2][j] = c2[j];
  }
  int m = kMaxElems;
  while (m > 0) {
    uint32_t any = 0;
    for (int j = 0; j < W; ++j) any |= e[m - 1][j];
    if (any) break;
    --m;
  }
  return m;
}

// prefix || m elements, padded, absorbed into s; returns the blocks absorbed.
MT_FN int absorb(uint64_t (&s)[keccak::kLanes], const uint64_t* prefix, int prefix_lanes,
                 const uint32_t (&e)[kMaxElems][W], int m) {
  uint64_t buf[keccak::kRateLanes * kMaxBlocks];
  for (int i = 0; i < keccak::kRateLanes * kMaxBlocks; ++i) buf[i] = 0;
  for (int i = 0; i < prefix_lanes; ++i) buf[i] = prefix[i];
  for (int q = 0; q < m; ++q) {
    for (int l = 0; l < W / 2; ++l) {
      buf[prefix_lanes + (W / 2) * q + l] = e[q][2 * l] | (uint64_t)e[q][2 * l + 1] << 32;
    }
  }
  const int used = prefix_lanes + (W / 2) * m;
  const int blocks = used / keccak::kRateLanes + 1;
  buf[used] ^= 0x01;
  buf[keccak::kRateLanes * blocks - 1] ^= kTopBit;
  for (int b = 0; b < blocks; ++b) {
#pragma unroll
    for (int i = 0; i < keccak::kRateLanes; ++i) s[i] ^= buf[keccak::kRateLanes * b + i];
    keccak::permute(s);
  }
  return blocks;
}

// One round. rows: (k, W + 1) lazy words, k = 2 or 3. The state starts at
// zero (fresh) or at state_in's 25 lanes; prefix holds prefix_lanes lanes (the
// last digest, or the host's pending tail). Writes the canonical rows (k, W)
// (coefficients for k = 3, untrimmed: the trimmed ones are zero), the new
// state's 25 lanes and the next challenge (W words, Montgomery form).
MT_FN void round_step(const uint32_t* rows, int k, const uint64_t* state_in, int fresh,
                      const uint64_t* prefix, int prefix_lanes, const Consts& C,
                      uint32_t* out_rows, uint64_t* state_out, uint32_t* challenge) {
  uint32_t e[kMaxElems][W];
  for (int i = 0; i < k; ++i) canonical(e[i], rows + i * (W + 1), C.M);
  const int m = k == 3 ? interpolate(e, C) : k;
  for (int i = 0; i < k; ++i) {
#pragma unroll
    for (int j = 0; j < W; ++j) out_rows[i * W + j] = e[i][j];
  }
  uint64_t s[keccak::kLanes];
#pragma unroll
  for (int i = 0; i < keccak::kLanes; ++i) s[i] = fresh ? 0 : state_in[i];
  absorb(s, prefix, prefix_lanes, e, m);
  uint32_t d[W], r[W];
#pragma unroll
  for (int l = 0; l < W / 2; ++l) {
    d[2 * l] = (uint32_t)s[l];
    d[2 * l + 1] = (uint32_t)(s[l] >> 32);
  }
  mont::mul<W>(r, C.r2, d, C.M);
#pragma unroll
  for (int i = 0; i < keccak::kLanes; ++i) state_out[i] = s[i];
#pragma unroll
  for (int j = 0; j < W; ++j) challenge[j] = r[j];
}

}  // namespace transcript

// Keccak-f[1600] on 25 uint64 lanes held in registers: the permutation under
// both transcript kernels of transcript_kernels.cu (keccak_f and round_step).
//
// Lane j = 5 y + x is the sponge's byte offset 8 j, the order of
// zktpu_torch/hash/keccak_device.py (there each lane is an int64 holding the
// same 64 bits). Every index and every rotation below is a constant, so the
// state never leaves registers; the round loop reads its constant from the
// constant bank. A rotation by 0 is the lane itself: nothing shifts by 64.
//
// Built with nvcc the functions are device code; built with a host C++ compiler
// (tests/test_torch_transcript_kernels.py does) the same code runs on the host.

#pragma once

#include <cstdint>

#ifdef __CUDACC__
#define KC_FN __device__ __forceinline__
#define KC_TABLE __constant__
#else
#define KC_FN inline
#define KC_TABLE static const
#endif

namespace keccak {

constexpr int kLanes = 25;
constexpr int kRounds = 24;
// the 136-byte rate of Keccak-256, in lanes
constexpr int kRateLanes = 17;

KC_TABLE uint64_t kRoundConstants[kRounds] = {
    0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull,
    0x8000000080008000ull, 0x000000000000808Bull, 0x0000000080000001ull,
    0x8000000080008081ull, 0x8000000000008009ull, 0x000000000000008Aull,
    0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
    0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull,
    0x8000000000008003ull, 0x8000000000008002ull, 0x8000000000000080ull,
    0x000000000000800Aull, 0x800000008000000Aull, 0x8000000080008081ull,
    0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull,
};

template <int R>
KC_FN uint64_t rotl(uint64_t x) {
  if constexpr (R == 0) {
    return x;
  } else {
    return (x << R) | (x >> (64 - R));
  }
}

// theta, rho, pi, chi and iota, 24 times
KC_FN void permute(uint64_t (&a)[kLanes]) {
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
    a[0] ^= kRoundConstants[round];
  }
}

}  // namespace keccak

// The carry-flag primitives under the package's two Montgomery cores: fq381.cuh
// (BLS12-381 Fq, the point kernels) and mont.cuh (the 8-word fields and W = 12,
// gkr_round and ntt_phase1).
//
// Each primitive is one PTX instruction on the integer pipe's carry flag:
// mad.lo.cc / madc.hi.cc / addc.cc and their kin. "cc" writes the flag, "c"
// reads it. The flag passes between consecutive asm statements, so a chain is
// only correct if no code between two of its instructions writes the flag: only
// .cc instructions do, and only these primitives emit them. Ordinary C++ between
// two links of a chain (an index computation, a load) is safe; a primitive of
// another chain is not.
//
// Built without CUDA (a host C++ compiler, as the CPU tests do), the primitives
// emulate the same instructions on a thread-local flag, so the cores' arithmetic
// can be held against Python integers and the plain PyTorch versions without a
// card.

#pragma once

#include <cstdint>

#ifdef __CUDACC__
#define CC_FN __device__ __forceinline__
#else
#define CC_FN inline
#endif

namespace carry {

#ifdef __CUDACC__

#define CC_OP3(name, ins)                                                   \
  CC_FN uint32_t name(uint32_t a, uint32_t b, uint32_t c) {                 \
    uint32_t d;                                                             \
    asm volatile(ins " %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c)); \
    return d;                                                               \
  }
#define CC_OP2(name, ins)                                          \
  CC_FN uint32_t name(uint32_t a, uint32_t b) {                    \
    uint32_t d;                                                    \
    asm volatile(ins " %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));   \
    return d;                                                      \
  }
CC_OP3(mad_lo_cc, "mad.lo.cc.u32")
CC_OP3(madc_lo_cc, "madc.lo.cc.u32")
CC_OP3(madc_hi_cc, "madc.hi.cc.u32")
CC_OP3(madc_hi, "madc.hi.u32")
CC_OP2(add_cc, "add.cc.u32")
CC_OP2(addc_cc, "addc.cc.u32")
CC_OP2(addc, "addc.u32")
CC_OP2(sub_cc, "sub.cc.u32")
CC_OP2(subc_cc, "subc.cc.u32")
CC_OP2(subc, "subc.u32")
#undef CC_OP3
#undef CC_OP2

CC_FN uint32_t mul_hi(uint32_t a, uint32_t b) { return __umulhi(a, b); }

#else  // host emulation of the same instructions

inline thread_local uint32_t host_cf = 0;

inline uint32_t emu_add(uint64_t s, bool cc) {
  if (cc) host_cf = (uint32_t)(s >> 32);
  return (uint32_t)s;
}
inline uint32_t emu_sub(uint64_t a, uint64_t b, bool cc) {
  if (cc) host_cf = a < b;
  return (uint32_t)(a - b);
}
inline uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  return emu_add((uint64_t)(uint32_t)(a * b) + c, true);
}
inline uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  return emu_add((uint64_t)(uint32_t)(a * b) + c + host_cf, true);
}
inline uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  return emu_add((((uint64_t)a * b) >> 32) + c + host_cf, true);
}
inline uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c) {
  return emu_add((((uint64_t)a * b) >> 32) + c + host_cf, false);
}
inline uint32_t add_cc(uint32_t a, uint32_t b) { return emu_add((uint64_t)a + b, true); }
inline uint32_t addc_cc(uint32_t a, uint32_t b) { return emu_add((uint64_t)a + b + host_cf, true); }
inline uint32_t addc(uint32_t a, uint32_t b) { return emu_add((uint64_t)a + b + host_cf, false); }
inline uint32_t sub_cc(uint32_t a, uint32_t b) { return emu_sub(a, b, true); }
inline uint32_t subc_cc(uint32_t a, uint32_t b) { return emu_sub(a, (uint64_t)b + host_cf, true); }
inline uint32_t subc(uint32_t a, uint32_t b) { return emu_sub(a, (uint64_t)b + host_cf, false); }
inline uint32_t mul_hi(uint32_t a, uint32_t b) { return (uint32_t)(((uint64_t)a * b) >> 32); }

struct alignas(16) uint4 {
  uint32_t x, y, z, w;
};

#endif

}  // namespace carry

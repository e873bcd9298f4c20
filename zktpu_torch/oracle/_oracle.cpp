/* Host C++ field-arithmetic oracle: an implementation of the prime-field
 * operations that shares nothing with the Montgomery code it checks (the
 * CUDA kernels of csrc/ and the plain PyTorch versions beside them).
 *
 * Representation: little-endian w x 64-bit words (w <= 8, so fields up to
 * 512 bits), plain (non-Montgomery) canonical values < p. Schoolbook
 * multiply with unsigned __int128 accumulation, then reduction by binary
 * shift-subtract long division -- slow but simple and obviously correct;
 * this is a test oracle, not a hot path.
 *
 * Built by zktpu_torch/_build.py (g++ -O2 -shared -fPIC) into
 * zktpu_torch/_build/ at first use.
 * API (ctypes; a, b, e, p, r, out: little-endian u64[w]; xs: u64[w * n]):
 *   void f_add(const u64* a, const u64* b, const u64* p, int w, u64* out);
 *   void f_sub(const u64* a, const u64* b, const u64* p, int w, u64* out);
 *   void f_mul(const u64* a, const u64* b, const u64* p, int w, u64* out);
 *   void f_pow(const u64* a, const u64* e, const u64* p, int w, u64* out);
 *   void f_sum(const u64* xs, size_t n, const u64* p, int w, u64* out);
 *   void f_fold(const u64* xs, size_t n, const u64* r, const u64* p, int w, u64* out);
 *     -- sumcheck fold: out[i] = xs[i] + r*(xs[i+n/2]-xs[i]) for i < n/2
 */

#include <cstdint>
#include <cstring>
#include <cstddef>

typedef uint64_t u64;
typedef unsigned __int128 u128;

#define MAXW 8

static int cmpw(const u64* a, const u64* b, int w) {
  for (int i = w - 1; i >= 0; --i) {
    if (a[i] != b[i]) return a[i] < b[i] ? -1 : 1;
  }
  return 0;
}

static u64 addw(const u64* a, const u64* b, int w, u64* out) {
  u128 c = 0;
  for (int i = 0; i < w; ++i) {
    u128 s = (u128)a[i] + b[i] + c;
    out[i] = (u64)s;
    c = s >> 64;
  }
  return (u64)c;
}

static u64 subw(const u64* a, const u64* b, int w, u64* out) {
  u128 borrow = 0;
  for (int i = 0; i < w; ++i) {
    u128 d = (u128)a[i] - b[i] - borrow;
    out[i] = (u64)d;
    borrow = (d >> 64) ? 1 : 0;
  }
  return (u64)borrow;
}

extern "C" void f_add(const u64* a, const u64* b, const u64* p, int w, u64* out) {
  u64 t[MAXW], r[MAXW];
  u64 carry = addw(a, b, w, t);
  if (carry || cmpw(t, p, w) >= 0) {
    subw(t, p, w, r);
    memcpy(out, r, 8 * w);
  } else {
    memcpy(out, t, 8 * w);
  }
}

extern "C" void f_sub(const u64* a, const u64* b, const u64* p, int w, u64* out) {
  u64 t[MAXW], r[MAXW];
  if (subw(a, b, w, t)) {
    addw(t, p, w, r);
    memcpy(out, r, 8 * w);
  } else {
    memcpy(out, t, 8 * w);
  }
}

/* 2w-word product reduced mod p by binary shift-subtract long division. */
extern "C" void f_mul(const u64* a, const u64* b, const u64* p, int w, u64* out) {
  u64 prod[2 * MAXW] = {0};
  for (int i = 0; i < w; ++i) {
    u128 carry = 0;
    for (int j = 0; j < w; ++j) {
      u128 cur = (u128)prod[i + j] + (u128)a[i] * b[j] + carry;
      prod[i + j] = (u64)cur;
      carry = cur >> 64;
    }
    prod[i + w] = (u64)carry;
  }
  u64 rem[MAXW] = {0};
  for (int bit = 128 * w - 1; bit >= 0; --bit) {
    u64 top = rem[w - 1] >> 63;
    for (int i = w - 1; i > 0; --i) rem[i] = (rem[i] << 1) | (rem[i - 1] >> 63);
    rem[0] <<= 1;
    rem[0] |= (prod[bit / 64] >> (bit % 64)) & 1;
    if (top || cmpw(rem, p, w) >= 0) {
      u64 t[MAXW];
      subw(rem, p, w, t);
      memcpy(rem, t, 8 * w);
    }
  }
  memcpy(out, rem, 8 * w);
}

extern "C" void f_pow(const u64* a, const u64* e, const u64* p, int w, u64* out) {
  u64 acc[MAXW] = {1};
  u64 base[MAXW];
  memcpy(base, a, 8 * w);
  int top = 64 * w;  /* one past the exponent's highest set bit */
  while (top > 0 && !((e[(top - 1) / 64] >> ((top - 1) % 64)) & 1)) --top;
  for (int bit = 0; bit < top; ++bit) {
    u64 t[MAXW];
    if ((e[bit / 64] >> (bit % 64)) & 1) {
      f_mul(acc, base, p, w, t);
      memcpy(acc, t, 8 * w);
    }
    f_mul(base, base, p, w, t);
    memcpy(base, t, 8 * w);
  }
  memcpy(out, acc, 8 * w);
}

extern "C" void f_sum(const u64* xs, size_t n, const u64* p, int w, u64* out) {
  u64 acc[MAXW] = {0};
  for (size_t i = 0; i < n; ++i) {
    u64 t[MAXW];
    f_add(acc, xs + w * i, p, w, t);
    memcpy(acc, t, 8 * w);
  }
  memcpy(out, acc, 8 * w);
}

extern "C" void f_fold(const u64* xs, size_t n, const u64* r, const u64* p,
                       int w, u64* out) {
  size_t half = n / 2;
  for (size_t i = 0; i < half; ++i) {
    u64 diff[MAXW], prod[MAXW];
    f_sub(xs + w * (half + i), xs + w * i, p, w, diff);
    f_mul(r, diff, p, w, prod);
    f_add(xs + w * i, prod, p, w, out + w * i);
  }
}

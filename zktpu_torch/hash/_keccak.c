/* Keccak-256 (legacy 0x01 padding, as used by the Rust `sha3` crate's
 * Keccak256 type and by Ethereum) -- native host hashing for the Fiat-Shamir
 * transcript and Merkle tree.
 *
 * The transcript absorbs entire evaluation tables (e.g. 32 MiB for a 2^20-entry
 * sumcheck), so the
 * host hash must be fast; pure Python keccak-f is ~1000x too slow.
 *
 * Build: gcc -O3 -shared -fPIC -o libzkkeccak.so _keccak.c
 * Exposed API (ctypes):
 *   void keccak256(const uint8_t *in, size_t len, uint8_t out[32]);
 *   void keccak256_batch(const uint8_t *in, size_t msg_len, size_t n,
 *                        uint8_t *out);  // n messages of equal msg_len
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>

#define ROTL64(x, n) (((x) << (n)) | ((x) >> (64 - (n))))

static const uint64_t RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

static const int RHO[25] = {0,  1,  62, 28, 27, 36, 44, 6,  55, 20, 3,  10, 43,
                            25, 39, 41, 45, 15, 21, 8,  18, 2,  61, 56, 14};

static void keccak_f(uint64_t st[25]) {
  uint64_t bc[5], t;
  uint64_t tmp[25];
  for (int round = 0; round < 24; round++) {
    /* theta (unrolled) */
    bc[0] = st[0] ^ st[5] ^ st[10] ^ st[15] ^ st[20];
    bc[1] = st[1] ^ st[6] ^ st[11] ^ st[16] ^ st[21];
    bc[2] = st[2] ^ st[7] ^ st[12] ^ st[17] ^ st[22];
    bc[3] = st[3] ^ st[8] ^ st[13] ^ st[18] ^ st[23];
    bc[4] = st[4] ^ st[9] ^ st[14] ^ st[19] ^ st[24];
#define THETA(i)                                                   \
    t = bc[(i + 4) % 5] ^ ROTL64(bc[(i + 1) % 5], 1);              \
    st[i] ^= t; st[i + 5] ^= t; st[i + 10] ^= t; st[i + 15] ^= t;  \
    st[i + 20] ^= t;
    THETA(0) THETA(1) THETA(2) THETA(3) THETA(4)
#undef THETA
    /* rho + pi (dest lane (y, 2x+3y); flat index = x + 5*y), unrolled */
#define RP(x, y) tmp[(y) + 5 * ((2 * (x) + 3 * (y)) % 5)] = \
    ROTL64(st[(x) + 5 * (y)], RHO[(x) + 5 * (y)]);
    RP(0,0) RP(0,1) RP(0,2) RP(0,3) RP(0,4)
    RP(1,0) RP(1,1) RP(1,2) RP(1,3) RP(1,4)
    RP(2,0) RP(2,1) RP(2,2) RP(2,3) RP(2,4)
    RP(3,0) RP(3,1) RP(3,2) RP(3,3) RP(3,4)
    RP(4,0) RP(4,1) RP(4,2) RP(4,3) RP(4,4)
#undef RP
    /* chi (unrolled per row) */
#define CHI(y)                                                          \
    st[0 + 5*(y)] = tmp[0 + 5*(y)] ^ ((~tmp[1 + 5*(y)]) & tmp[2 + 5*(y)]); \
    st[1 + 5*(y)] = tmp[1 + 5*(y)] ^ ((~tmp[2 + 5*(y)]) & tmp[3 + 5*(y)]); \
    st[2 + 5*(y)] = tmp[2 + 5*(y)] ^ ((~tmp[3 + 5*(y)]) & tmp[4 + 5*(y)]); \
    st[3 + 5*(y)] = tmp[3 + 5*(y)] ^ ((~tmp[4 + 5*(y)]) & tmp[0 + 5*(y)]); \
    st[4 + 5*(y)] = tmp[4 + 5*(y)] ^ ((~tmp[0 + 5*(y)]) & tmp[1 + 5*(y)]);
    CHI(0) CHI(1) CHI(2) CHI(3) CHI(4)
#undef CHI
    /* iota */
    st[0] ^= RC[round];
  }
}

#define RATE 136 /* Keccak-256 rate in bytes */

void keccak256(const uint8_t *in, size_t len, uint8_t *out) {
  uint64_t st[25];
  memset(st, 0, sizeof(st));
  /* absorb full blocks */
  while (len >= RATE) {
    for (int i = 0; i < RATE / 8; i++) {
      uint64_t w;
      memcpy(&w, in + 8 * i, 8);
      st[i] ^= w;
    }
    keccak_f(st);
    in += RATE;
    len -= RATE;
  }
  /* final block with 0x01 ... 0x80 padding (legacy Keccak, NOT SHA-3) */
  uint8_t block[RATE];
  memset(block, 0, RATE);
  memcpy(block, in, len);
  block[len] = 0x01;
  block[RATE - 1] |= 0x80;
  for (int i = 0; i < RATE / 8; i++) {
    uint64_t w;
    memcpy(&w, block + 8 * i, 8);
    st[i] ^= w;
  }
  keccak_f(st);
  memcpy(out, st, 32);
}

void keccak256_batch(const uint8_t *in, size_t msg_len, size_t n, uint8_t *out) {
  for (size_t i = 0; i < n; i++)
    keccak256(in + i * msg_len, msg_len, out + i * 32);
}

/* Absorb the full RATE-byte blocks of `in` into a zero sponge and write the
 * 200-byte state; the caller keeps the len % RATE tail bytes. Used to hand a
 * partially-absorbed transcript (e.g. a 32 MiB evaluation table) to the
 * on-device Fiat-Shamir continuation (zktpu_torch/hash/keccak_device.py). */
void keccak_absorb_state(const uint8_t *in, size_t len, uint8_t *state_out) {
  uint64_t st[25];
  memset(st, 0, sizeof(st));
  while (len >= RATE) {
    for (int i = 0; i < RATE / 8; i++) {
      uint64_t w;
      memcpy(&w, in + 8 * i, 8);
      st[i] ^= w;
    }
    keccak_f(st);
    in += RATE;
    len -= RATE;
  }
  memcpy(state_out, st, 200);
}

/* Absorb the full blocks of `in` into an EXISTING 200-byte state (streaming
 * transcript append); caller retains len % RATE tail bytes. */
void keccak_absorb_into(uint8_t *state, const uint8_t *in, size_t len) {
  uint64_t st[25];
  memcpy(st, state, 200);
  while (len >= RATE) {
    for (int i = 0; i < RATE / 8; i++) {
      uint64_t w;
      memcpy(&w, in + 8 * i, 8);
      st[i] ^= w;
    }
    keccak_f(st);
    in += RATE;
    len -= RATE;
  }
  memcpy(state, st, 200);
}

/* Digest of (already-absorbed state || tail) with legacy 0x01 padding,
 * WITHOUT mutating the state: the transcript finalize_reset step. */
void keccak256_resume(const uint8_t *state, const uint8_t *tail, size_t len,
                      uint8_t *out) {
  uint64_t st[25];
  memcpy(st, state, 200);
  uint8_t block[RATE];
  memset(block, 0, RATE);
  memcpy(block, tail, len);
  block[len] = 0x01;
  block[RATE - 1] |= 0x80;
  for (int i = 0; i < RATE / 8; i++) {
    uint64_t w;
    memcpy(&w, block + 8 * i, 8);
    st[i] ^= w;
  }
  keccak_f(st);
  memcpy(out, st, 32);
}

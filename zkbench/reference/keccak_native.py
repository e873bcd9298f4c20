"""Keccak-256 (legacy 0x01 padding, Rust ``sha3::Keccak256``) in a few dozen
lines of C, and the reference transcript on it.

This is the one part of the references that is not plain PyTorch or Python:
the plain sumcheck's transcript absorbs the whole table, 2^20 x 32 bytes at the
configuration's size, some 250,000 permutations, and ``keccak.py``'s pure
Python permutation takes about a millisecond each, some 260 s a check. The C
below is written from the specification (FIPS 202, the sponge of Keccak-f[1600]
at rate 136), not taken from the program's own sponge; ``keccak.py`` is the
readable version that the tests hold this one to.

The library is built at first use with the host's C compiler into a directory
of the temporary folder named by a hash of the source, so nothing inside the
checkout changes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

from . import keccak

SOURCE = r"""
#include <stddef.h>
#include <stdint.h>
#include <string.h>

static const uint64_t RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,
    0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
    0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

/* rotation of lane (x, y), at index x + 5 y */
static const int ROT[25] = {0, 1, 62, 28, 27, 36, 44, 6, 55, 20, 3, 10, 43,
                            25, 39, 41, 45, 15, 21, 8, 18, 2, 61, 56, 14};

static uint64_t rotl(uint64_t v, int n) { return n ? (v << n) | (v >> (64 - n)) : v; }

static void permute(uint64_t a[25]) {
    uint64_t c[5], b[25];
    for (int round = 0; round < 24; round++) {
        for (int x = 0; x < 5; x++) c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
        for (int x = 0; x < 5; x++) {
            uint64_t d = c[(x + 4) % 5] ^ rotl(c[(x + 1) % 5], 1);
            for (int y = 0; y < 25; y += 5) a[x + y] ^= d;
        }
        for (int x = 0; x < 5; x++)
            for (int y = 0; y < 5; y++)
                b[y + 5 * ((2 * x + 3 * y) % 5)] = rotl(a[x + 5 * y], ROT[x + 5 * y]);
        for (int y = 0; y < 25; y += 5)
            for (int x = 0; x < 5; x++)
                a[x + y] = b[x + y] ^ (~b[(x + 1) % 5 + y] & b[(x + 2) % 5 + y]);
        a[0] ^= RC[round];
    }
}

static void absorb(uint64_t a[25], const uint8_t *block) {
    for (int i = 0; i < 17; i++) {
        uint64_t lane = 0;
        for (int j = 7; j >= 0; j--) lane = (lane << 8) | block[8 * i + j];
        a[i] ^= lane;
    }
    permute(a);
}

void keccak256(const uint8_t *data, size_t len, uint8_t *out) {
    uint64_t a[25] = {0};
    uint8_t last[136] = {0};
    size_t off = 0;
    for (; len - off >= 136; off += 136) absorb(a, data + off);
    memcpy(last, data + off, len - off);
    last[len - off] ^= 0x01;
    last[135] ^= 0x80;
    absorb(a, last);
    for (int i = 0; i < 32; i++) out[i] = (uint8_t)(a[i / 8] >> (8 * (i % 8)));
}
"""

_lib = None


def _library():
    """The built library, built on the first call."""
    global _lib
    if _lib is None:
        tag = hashlib.sha256(SOURCE.encode()).hexdigest()[:16]
        folder = os.path.join(tempfile.gettempdir(), f"zkbench_keccak_{tag}")
        path = os.path.join(folder, "libkeccak.so")
        if not os.path.exists(path):
            os.makedirs(folder, exist_ok=True)
            source = os.path.join(folder, "keccak.c")
            with open(source, "w") as f:
                f.write(SOURCE)
            fd, part = tempfile.mkstemp(suffix=".so.part", dir=folder)
            os.close(fd)
            try:
                subprocess.run(["cc", "-O2", "-shared", "-fPIC", source, "-o", part],
                               check=True, capture_output=True, text=True)
                os.replace(part, path)  # whole or not at all, for a concurrent build
            finally:
                if os.path.exists(part):
                    os.remove(part)
        lib = ctypes.CDLL(path)
        lib.keccak256.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p]
        lib.keccak256.restype = None
        _lib = lib
    return _lib


def keccak256(data: bytes) -> bytes:
    data = bytes(data)
    out = ctypes.create_string_buffer(32)
    _library().keccak256(data, len(data), out)
    return out.raw


class Transcript(keccak.Transcript):
    """``keccak.Transcript`` (pending bytes; a squeeze hashes them, the digest
    is the new prefix and, little-endian modulo the field's order, the
    challenge) with the hash in C."""

    def challenge(self) -> int:
        digest = keccak256(self.pending)
        self.pending = bytearray(digest)
        return int.from_bytes(digest, "little") % self.modulus

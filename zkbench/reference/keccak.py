"""Keccak-256 with the legacy 0x01 padding (Rust ``sha3::Keccak256``), in plain
Python, and the Fiat-Shamir transcript of the reference GKR built on it.

The transcript keeps the bytes appended since the last squeeze; a squeeze
hashes them, starts again from the 32-byte digest, and maps the digest to the
field as a little-endian integer reduced modulo the field's order. Everything
the GKR reference hashes is small, so no streaming is needed.
"""

from __future__ import annotations

_RATE = 136
_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
# rotation of lane (x, y), indexed [x][y]
_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]
_M = (1 << 64) - 1


def _rotl(v: int, n: int) -> int:
    return ((v << n) | (v >> (64 - n))) & _M if n else v


def _permute(a: list[int]) -> None:
    """Keccak-f[1600] on 25 lanes, lane (x, y) at index x + 5 y, in place."""
    for rc in _RC:
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        for x in range(5):
            d = c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1)
            for y in range(0, 25, 5):
                a[x + y] ^= d
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(a[x + 5 * y], _ROT[x][y])
        for y in range(0, 25, 5):
            row = b[y: y + 5]
            for x in range(5):
                a[x + y] = row[x] ^ (~row[(x + 1) % 5] & row[(x + 2) % 5] & _M)
        a[0] ^= rc


def keccak256(data: bytes) -> bytes:
    padded = bytearray(data)
    padded.append(0x01)
    padded.extend(b"\x00" * ((-len(padded)) % _RATE))
    padded[-1] |= 0x80
    a = [0] * 25
    for off in range(0, len(padded), _RATE):
        for i in range(_RATE // 8):
            a[i] ^= int.from_bytes(padded[off + 8 * i: off + 8 * i + 8], "little")
        _permute(a)
    return b"".join(a[i].to_bytes(8, "little") for i in range(4))


class Transcript:
    """The reference's Keccak transcript over a prime field of ``byte_len``-byte
    elements."""

    def __init__(self, modulus: int, byte_len: int = 32):
        self.modulus = modulus
        self.byte_len = byte_len
        self.pending = bytearray()

    def append(self, data: bytes) -> None:
        self.pending += data

    def append_field_elements(self, values) -> None:
        for v in values:
            self.pending += (int(v) % self.modulus).to_bytes(self.byte_len, "little")

    def challenge(self) -> int:
        digest = keccak256(bytes(self.pending))
        self.pending = bytearray(digest)
        return int.from_bytes(digest, "little") % self.modulus

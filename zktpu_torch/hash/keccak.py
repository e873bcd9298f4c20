"""Keccak-256 with the legacy 0x01 padding (Rust ``sha3::Keccak256``).

This is the hash behind the reference's Fiat-Shamir transcript
(fiat_shamir/src/fiat_shamir_transcript.rs:2) and its Merkle tree
(merkle_tree/src/merkle_tree.rs:3). NOTE: this is *not*
SHA3-256 -- the final padding byte is 0x01, not 0x06 -- so ``hashlib.sha3_256``
cannot be used.

Two backends:
  * a C implementation (``_keccak.c``) compiled on demand into the package's
    build directory and loaded via ctypes -- the production path; the
    transcript absorbs multi-MiB evaluation tables so host hashing must be
    native.
  * a pure-Python fallback used if no C toolchain is available. ``backend()``
    says which one is in use.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from .. import _build

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
_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]
_MASK64 = (1 << 64) - 1


def _rotl(x: int, n: int) -> int:
    n %= 64
    return ((x << n) | (x >> (64 - n))) & _MASK64


def _keccak_f(lanes):
    # lanes[x][y], 5x5 of 64-bit ints
    for rc in _RC:
        # theta
        c = [lanes[x][0] ^ lanes[x][1] ^ lanes[x][2] ^ lanes[x][3] ^ lanes[x][4] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        lanes = [[lanes[x][y] ^ d[x] for y in range(5)] for x in range(5)]
        # rho + pi
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rotl(lanes[x][y], _ROT[x][y])
        # chi
        lanes = [
            [b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y] & _MASK64) for y in range(5)]
            for x in range(5)
        ]
        # iota
        lanes[0][0] ^= rc
    return lanes


def _keccak256_py(data: bytes) -> bytes:
    lanes = [[0] * 5 for _ in range(5)]

    def absorb(block: bytes):
        nonlocal lanes
        for i in range(_RATE // 8):
            w = int.from_bytes(block[8 * i : 8 * i + 8], "little")
            x, y = i % 5, i // 5
            lanes[x][y] ^= w
        lanes = _keccak_f(lanes)

    off = 0
    while len(data) - off >= _RATE:
        absorb(data[off : off + _RATE])
        off += _RATE
    block = bytearray(_RATE)
    tail = data[off:]
    block[: len(tail)] = tail
    block[len(tail)] ^= 0x01
    block[_RATE - 1] ^= 0x80
    absorb(bytes(block))

    out = bytearray()
    for i in range(4):
        x, y = i % 5, i // 5
        out += lanes[x][y].to_bytes(8, "little")
    return bytes(out)


# ----------------------------------------------------------------------
# native backend
# ----------------------------------------------------------------------
_HERE = os.path.dirname(os.path.abspath(__file__))
# no -march=native: a build directory may travel to a machine with another CPU
_GCC_FLAGS = ["-O3", "-funroll-loops"]
_lib = None
_native_failed = False


def _load_native():
    """The C sponge, built at first use; None where no C toolchain works."""
    global _lib, _native_failed
    if _lib is not None or _native_failed:
        return _lib
    try:
        path = _build.host_library_path(
            "zkkeccak", os.path.join(_HERE, "_keccak.c"), _GCC_FLAGS
        )
        lib = ctypes.CDLL(path)
    except (_build.CompileError, OSError):
        _native_failed = True
        return None
    lib.keccak256.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p]
    lib.keccak256_batch.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_char_p,
    ]
    lib.keccak_absorb_state.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p]
    lib.keccak_absorb_into.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t]
    lib.keccak256_resume.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
    ]
    for fn in (lib.keccak256, lib.keccak256_batch, lib.keccak_absorb_state,
               lib.keccak_absorb_into, lib.keccak256_resume):
        fn.restype = None
    _lib = lib
    return lib


def backend() -> str:
    """``"c"`` when the native sponge is loaded, ``"python"`` otherwise."""
    return "c" if _load_native() is not None else "python"


def keccak256(data: bytes) -> bytes:
    """Keccak-256 digest (32 bytes) with legacy 0x01 padding."""
    lib = _load_native()
    if lib is not None:
        out = ctypes.create_string_buffer(32)
        lib.keccak256(bytes(data), len(data), out)
        return out.raw
    return _keccak256_py(bytes(data))


def keccak256_batch(messages_blob: bytes, msg_len: int) -> bytes:
    """Hash ``len(blob)//msg_len`` equal-length messages; returns concatenated
    32-byte digests. Used for batched Merkle leaf/node hashing on host."""
    n = len(messages_blob) // msg_len
    lib = _load_native()
    if lib is not None:
        out = ctypes.create_string_buffer(32 * n)
        lib.keccak256_batch(bytes(messages_blob), msg_len, n, out)
        return out.raw
    return b"".join(
        _keccak256_py(messages_blob[i * msg_len : (i + 1) * msg_len]) for i in range(n)
    )


def sponge_state_after(data: bytes):
    """Sponge state after absorbing the full 136-byte blocks of ``data``.

    Returns ``(state, tail)``: ``state`` is a (25, 2) uint32 little-endian
    lane-pair array (``keccak_device.pairs_to_lanes`` packs them) and ``tail`` the
    unabsorbed ``len(data) % 136`` bytes. Hands a partially-absorbed
    transcript to the on-device Fiat-Shamir continuation.
    """
    n_tail = len(data) % _RATE
    body, tail = data[: len(data) - n_tail], data[len(data) - n_tail :]
    lib = _load_native()
    if lib is not None:
        out = ctypes.create_string_buffer(200)
        lib.keccak_absorb_state(bytes(body), len(body), out)
        state_bytes = out.raw
    else:
        lanes = [[0] * 5 for _ in range(5)]
        for off in range(0, len(body), _RATE):
            for i in range(_RATE // 8):
                w = int.from_bytes(body[off + 8 * i : off + 8 * i + 8], "little")
                lanes[i % 5][i // 5] ^= w
            lanes = _keccak_f(lanes)
        state_bytes = b"".join(
            lanes[i % 5][i // 5].to_bytes(8, "little") for i in range(25)
        )
    state = np.frombuffer(state_bytes, dtype="<u4").reshape(25, 2).astype(np.uint32)
    return state, tail


class Sponge:
    """Streaming Keccak-256 sponge (legacy padding): absorb incrementally,
    squeeze without rehashing everything absorbed so far.

    ``state`` is the 200-byte register after all full blocks; ``tail`` the
    < 136 unabsorbed bytes. ``digest()`` does not mutate. Pure-Python
    fallback mirrors the C path bit for bit.
    """

    __slots__ = ("_state", "_tail")

    def __init__(self, state: bytes | None = None, tail: bytes = b""):
        self._state = bytearray(state if state is not None else bytes(200))
        self._tail = bytearray(tail)
        if len(self._tail) >= _RATE:
            self._absorb_full()

    def copy(self) -> "Sponge":
        return Sponge(bytes(self._state), bytes(self._tail))

    def _absorb_full(self) -> None:
        n_full = len(self._tail) // _RATE
        if not n_full:
            return
        body = bytes(self._tail[: n_full * _RATE])
        del self._tail[: n_full * _RATE]
        lib = _load_native()
        if lib is not None:
            buf = ctypes.create_string_buffer(bytes(self._state), 200)
            lib.keccak_absorb_into(buf, body, len(body))
            self._state = bytearray(buf.raw[:200])
            return
        lanes = [
            [
                int.from_bytes(self._state[8 * (x + 5 * y) : 8 * (x + 5 * y) + 8], "little")
                for y in range(5)
            ]
            for x in range(5)
        ]
        for off in range(0, len(body), _RATE):
            for i in range(_RATE // 8):
                w = int.from_bytes(body[off + 8 * i : off + 8 * i + 8], "little")
                lanes[i % 5][i // 5] ^= w
            lanes = _keccak_f(lanes)
        self._state = bytearray(
            b"".join(lanes[i % 5][i // 5].to_bytes(8, "little") for i in range(25))
        )

    def absorb(self, data: bytes) -> None:
        self._tail += data
        if len(self._tail) >= _RATE:
            self._absorb_full()

    def digest(self) -> bytes:
        lib = _load_native()
        if lib is not None:
            out = ctypes.create_string_buffer(32)
            lib.keccak256_resume(bytes(self._state), bytes(self._tail), len(self._tail), out)
            return out.raw
        probe = Sponge(bytes(self._state))
        block = bytearray(bytes(self._tail).ljust(_RATE, b"\x00"))
        block[len(self._tail)] ^= 0x01
        block[_RATE - 1] ^= 0x80
        probe._tail = bytearray(block)
        probe._absorb_full()
        return bytes(probe._state[:32])

    def state_lanes(self):
        """(25, 2) uint32 lane pairs + tail bytes, for the device handoff."""
        return (
            np.frombuffer(bytes(self._state), dtype="<u4").reshape(25, 2).astype(np.uint32),
            bytes(self._tail),
        )

"""Keccak-f[1600] and the Fiat-Shamir squeeze on the device (plain PyTorch).

The counterpart of ``zktpu/hash/keccak_device.py``. The transcript squeeze
between sumcheck rounds is the serial dependency of the whole protocol; keeping
the sponge state ON the device removes every per-round host round trip, so the
fused prover (``zktpu_torch.sumcheck.fused``) touches the host twice per proof.

Representation: one 64-bit lane per ``torch.int64`` element (the reference keeps
(lo, hi) pairs of uint32 because its chip has no 64-bit integers; this one has).
The state is a ``(25,)`` int64 tensor with flat lane index j = 5*y + x, matching
the byte-stream order of the sponge (byte offset of lane j = 8*j). PyTorch's
right shift on int64 is arithmetic, so a rotation masks the bits it shifts down.
All rotations and permutations use constant per-lane vectors, built once per
device. This is eager PyTorch: one keccak-f is some hundreds of tiny launches.
It is not a hand-written kernel because the reference's is not one either.

Bit-exactness contract: identical output to ``zktpu_torch.hash.keccak.keccak256``
(Rust ``sha3::Keccak256``, legacy 0x01 padding).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_I64 = torch.int64

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
# rotation offsets indexed [x][y] (same table as the host implementation)
_ROT_XY = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

RATE = 136  # Keccak-256 rate in bytes (17 lanes)
RATE_LANES = RATE // 8

# flat-lane (j = 5y + x) constant tables for rho+pi:
#   B[5*y2 + x2] = rotl(S[5*y + x], ROT[x][y])  with x2 = y, y2 = (2x+3y) % 5
_ROTS = np.zeros(25, np.int64)
_PI_SRC = np.zeros(25, np.int64)
for _x in range(5):
    for _y in range(5):
        _dst = 5 * ((2 * _x + 3 * _y) % 5) + _y
        _ROTS[_dst] = _ROT_XY[_x][_y] % 64
        _PI_SRC[_dst] = 5 * _y + _x


def _as_i64(values) -> np.ndarray:
    """Python ints in [0, 2^64) -> the int64 with the same bits."""
    return np.asarray(values, dtype=np.uint64).view(np.int64)


class _Consts:
    """Per-device constant vectors of the permutation."""

    def __init__(self, device: torch.device):
        def dev(arr):
            return torch.from_numpy(np.ascontiguousarray(arr)).to(device)

        def rot_consts(rots):
            rots = np.asarray(rots, np.int64)
            # rotl(x, r) = (x << r) | ((x >> (64 - r)) & (2^r - 1)); r = 0 -> x
            return (
                dev(rots),
                dev((64 - rots) % 64),
                dev(_as_i64([(1 << int(r)) - 1 for r in rots])),
            )

        self.rho = rot_consts(_ROTS)
        self.pi_src = dev(_PI_SRC)
        x = np.arange(5)
        self.col_prev = dev((x - 1) % 5)  # c[x-1]
        self.col_next = dev((x + 1) % 5)  # c[x+1]
        j = np.arange(25)
        row, col = j // 5, j % 5
        self.chi1 = dev(5 * row + (col + 1) % 5)
        self.chi2 = dev(5 * row + (col + 2) % 5)
        rc = np.zeros((24, 25), np.int64)
        rc[:, 0] = _as_i64(_RC)
        self.rc = dev(rc)  # iota as a full-state xor: only lane 0 is non-zero


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device) -> _Consts:
    return _Consts(device)


def keccak_f(state):
    """One Keccak-f[1600] permutation on a (25,) int64 lane tensor."""
    k = _consts(state.device)
    rho_l, rho_r, rho_mask = k.rho
    s = state
    for rnd in range(24):
        # theta
        grid = s.reshape(5, 5)  # [y, x]
        c = grid[0] ^ grid[1] ^ grid[2] ^ grid[3] ^ grid[4]  # (5,) over x
        cn = c[k.col_next]
        d = c[k.col_prev] ^ ((cn << 1) | ((cn >> 63) & 1))
        s = (grid ^ d).reshape(25)
        # rho + pi
        b = s[k.pi_src]
        b = (b << rho_l) | ((b >> rho_r) & rho_mask)
        # chi, iota
        s = b ^ (~b[k.chi1] & b[k.chi2]) ^ k.rc[rnd]
    return s


def bytes_to_lanes(data: bytes) -> np.ndarray:
    """Static bytes -> (ceil(len/8),) int64 lanes on the host (zero padded)."""
    pad = (-len(data)) % 8
    return np.frombuffer(data + b"\0" * pad, dtype="<i8").copy()


def pairs_to_lanes(pairs) -> np.ndarray:
    """(k, 2) uint32 (lo, hi) pairs, as the host sponge exports its state ->
    (k,) int64 lanes."""
    pairs = np.ascontiguousarray(np.asarray(pairs).astype("<u4"))
    return pairs.view("<i8").reshape(-1).copy()


def absorb_block(state, block_lanes):
    """XOR one RATE-byte block (17 lanes) into the state and permute."""
    mixed = torch.cat([state[:RATE_LANES] ^ block_lanes, state[RATE_LANES:]])
    return keccak_f(mixed)


def keccak256_device(data: bytes, device):
    """Digest of static host bytes, computed on ``device`` (for tests)."""
    state = torch.zeros(25, dtype=_I64, device=device)
    n_full = len(data) // RATE
    for i in range(n_full):
        block = bytes_to_lanes(data[i * RATE : (i + 1) * RATE])
        state = absorb_block(state, torch.from_numpy(block).to(device))
    tail = bytearray(data[n_full * RATE :].ljust(RATE, b"\0"))
    tail[len(data) - n_full * RATE] ^= 0x01
    tail[RATE - 1] ^= 0x80
    state = absorb_block(state, torch.from_numpy(bytes_to_lanes(bytes(tail))).to(device))
    return state[:4]  # 32-byte digest as 4 lanes


def digest_to_bytes(digest_lanes) -> bytes:
    return digest_lanes.detach().cpu().numpy().astype("<i8").tobytes()


# ----------------------------------------------------------------------
# word <-> lane packing (field words are little-endian, so 2 words ARE one
# 64-bit lane -- no byte materialization on the device)
# ----------------------------------------------------------------------

def limbs_to_lanes(words):
    """(..., 2k) int32 words -> (..., k) int64 lanes."""
    shaped = words.reshape(words.shape[:-1] + (-1, 2)).to(_I64)
    return (shaped[..., 0] & 0xFFFFFFFF) | (shaped[..., 1] << 32)


def lanes_to_limbs(lanes):
    """(..., k) int64 lanes -> (..., 2k) int32 words."""
    lo = ((lanes & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000
    hi = lanes >> 32  # arithmetic shift: already the int32 with the same bits
    out = torch.stack([lo, hi], dim=-1).to(torch.int32)
    return out.reshape(lanes.shape[:-1] + (-1,))

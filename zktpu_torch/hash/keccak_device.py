"""The Fiat-Shamir sponge on the device: absorb, digest and lane packing.

The counterpart of ``zktpu/hash/keccak_device.py``. The transcript squeeze
between sumcheck rounds is the serial dependency of the whole protocol; keeping
the sponge state ON the device removes every per-round host round trip, so the
fused prover (``zktpu_torch.sumcheck.fused``) touches the host twice per proof.

Representation: one 64-bit lane per ``torch.int64`` element (the reference keeps
(lo, hi) pairs of uint32 because its chip has no 64-bit integers; this one has).
The state is a ``(25,)`` int64 tensor with flat lane index j = 5*y + x, matching
the byte-stream order of the sponge (byte offset of lane j = 8*j). The
permutation is ``hash.kernels.keccak_f``: the hand-written CUDA kernel on a card
tensor, its plain PyTorch version on a CPU one. The fused provers take a whole
round in one launch of ``hash.kernels.round_step`` instead; these functions are
the sponge's other entry points.

Bit-exactness contract: identical output to ``zktpu_torch.hash.keccak.keccak256``
(Rust ``sha3::Keccak256``, legacy 0x01 padding).
"""

from __future__ import annotations

import numpy as np
import torch

from .kernels import RATE, RATE_LANES, keccak_f, lanes_to_limbs, limbs_to_lanes

__all__ = [
    "RATE", "RATE_LANES", "keccak_f", "bytes_to_lanes", "pairs_to_lanes", "absorb_block",
    "keccak256_device", "digest_to_bytes", "limbs_to_lanes", "lanes_to_limbs",
]

_I64 = torch.int64


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
    """Digest of static host bytes, computed on ``device``: the padded bytes in
    one upload, then a permutation a block. Returns the 32-byte digest as 4
    lanes."""
    padded = bytearray(data + b"\0" * (RATE - len(data) % RATE))
    padded[len(data)] ^= 0x01
    padded[-1] ^= 0x80
    blocks = torch.from_numpy(bytes_to_lanes(bytes(padded))).to(device)
    state = torch.zeros(25, dtype=_I64, device=device)
    for i in range(len(padded) // RATE):
        state = absorb_block(state, blocks[RATE_LANES * i : RATE_LANES * (i + 1)])
    return state[:4]


def digest_to_bytes(digest_lanes) -> bytes:
    return digest_lanes.detach().cpu().numpy().astype("<i8").tobytes()

"""State carried between the JAX package's layouts and this package's.

Functions on numpy arrays; nothing here imports JAX. Both packages hold the
same integers in the same Montgomery domain, so every map is an exact
reinterpretation:

  * a field element is ``N`` 16-bit digits, one per uint32 lane, in ``zktpu``,
    and ``N / 2`` little-endian 32-bit words (int32 bit pattern) here;
  * a lazy sum row is ``N + 2`` digits there and ``N / 2 + 1`` words here;
  * a Keccak lane is a (lo, hi) pair of uint32 there and one int64 here.

The tests use these so that both packages compute on the same table and are
compared word for word.
"""

from __future__ import annotations

import numpy as np
import torch

from .hash.keccak_device import pairs_to_lanes
from .sumcheck.protocol import Proof


def _digits_to_words(digits) -> np.ndarray:
    digits = np.asarray(digits)
    if digits.shape[-1] % 2:
        raise ValueError("digit count must be even")
    if digits.size and int(digits.max()) > 0xFFFF:
        raise ValueError("digits must be clean 16-bit values")
    return np.ascontiguousarray(digits.astype("<u2")).view("<u4")


def _words_to_digits(words) -> np.ndarray:
    if isinstance(words, torch.Tensor):
        words = words.detach().cpu().numpy()
    words = np.ascontiguousarray(np.asarray(words).astype(np.int32, copy=False))
    return words.view("<u2").astype(np.uint32)


def table_from_zktpu(digits) -> torch.Tensor:
    """(..., N) uint32 16-bit digits -> (..., N/2) int32 word tensor (CPU)."""
    return torch.from_numpy(_digits_to_words(digits).view(np.int32).copy())


def table_to_zktpu(words) -> np.ndarray:
    """(..., N/2) int32 words (tensor or array) -> (..., N) uint32 digits."""
    return _words_to_digits(words)


def lazy_rows_from_zktpu(rows) -> torch.Tensor:
    """(k, N+2) lazy digit rows -> (k, N/2+1) word rows of the same integers.

    The reference's kernels add clean digit rows across grid steps without
    carrying, so a lane may exceed 16 bits; the integer it stands for is what is
    carried over."""
    rows = np.asarray(rows, dtype=np.uint64)
    nwords = rows.shape[-1] // 2
    out = np.zeros((rows.shape[0], nwords), dtype=np.uint32)
    for k, row in enumerate(rows):
        acc = sum(int(d) << (16 * i) for i, d in enumerate(row))
        if acc >> (32 * nwords):
            raise ValueError("lazy row does not fit its words")
        out[k] = np.frombuffer(acc.to_bytes(4 * nwords, "little"), dtype="<u4")
    return torch.from_numpy(out.view(np.int32))


def lazy_rows_to_zktpu(rows) -> np.ndarray:
    """(k, N/2+1) word rows -> (k, N+2) clean digit rows."""
    return _words_to_digits(rows)


def sponge_state_from_zktpu(pairs) -> torch.Tensor:
    """(k, 2) uint32 (lo, hi) lane pairs -> (k,) int64 lanes (CPU tensor)."""
    pairs = np.asarray(pairs)
    if pairs.ndim != 2 or pairs.shape[1] != 2:
        raise ValueError("expected (k, 2) lane pairs")
    return torch.from_numpy(pairs_to_lanes(pairs))


def sponge_state_to_zktpu(lanes) -> np.ndarray:
    """(k,) int64 lanes -> (k, 2) uint32 (lo, hi) lane pairs."""
    if isinstance(lanes, torch.Tensor):
        lanes = lanes.detach().cpu().numpy()
    lanes = np.ascontiguousarray(np.asarray(lanes, dtype="<i8"))
    return lanes.view("<u4").reshape(-1, 2).astype(np.uint32)


def proof_from_zktpu(proof) -> Proof:
    """``zktpu.sumcheck.protocol.Proof`` (any object with its two fields) ->
    this package's ``Proof``."""
    return Proof(
        [[int(v) for v in rp] for rp in proof.proof_polynomials], int(proof.claimed_sum)
    )


def proof_to_zktpu(proof: Proof, cls):
    """This package's ``Proof`` -> ``cls(proof_polynomials, claimed_sum)``; the
    caller passes ``zktpu.sumcheck.protocol.Proof`` as ``cls``."""
    return cls([[int(v) for v in rp] for rp in proof.proof_polynomials], int(proof.claimed_sum))

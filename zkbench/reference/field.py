"""Plain PyTorch arithmetic modulo a prime below 2^256, for the references.

An element is 16 limbs of 16 bits in int64 lanes, limb-major: a batch of
shape ``S`` is a ``(16, *S)`` tensor, limb 0 the least significant. Elements
are kept in Montgomery form, ``x R mod p`` with ``R = 2^256``; a product is the
schoolbook product of the limbs followed by a limb-by-limb Montgomery
reduction, and every result is reduced to ``[0, p)``.

Nothing here is fast: it is written to be read and checked. A limb product is
below 2^32 and a column of the 33-limb product accumulates at most 32 of them,
so int64 lanes never overflow.
"""

from __future__ import annotations

import numpy as np
import torch

LIMBS = 16
LIMB_BITS = 16
MASK = (1 << LIMB_BITS) - 1
R_BITS = LIMBS * LIMB_BITS


def int_to_limbs(value: int) -> list[int]:
    return [(value >> (LIMB_BITS * i)) & MASK for i in range(LIMBS)]


def ints_to_limb_array(values) -> np.ndarray:
    """Python ints below 2^256 -> (16, n) int64 limbs, on the host."""
    blob = b"".join(int(v).to_bytes(32, "little") for v in values)
    digits = np.frombuffer(blob, dtype="<u2").reshape(-1, LIMBS)
    return np.ascontiguousarray(digits.T).astype(np.int64)


def limb_array_to_ints(limbs: np.ndarray) -> list[int]:
    """(16, n) limbs, each below 2^16 -> Python ints."""
    blob = np.ascontiguousarray(limbs.T).astype("<u2").tobytes()
    return [int.from_bytes(blob[32 * i: 32 * i + 32], "little")
            for i in range(limbs.shape[1])]


class PrimeField:
    """Arithmetic modulo ``p`` on ``device``, in Montgomery form."""

    def __init__(self, p: int, device):
        if p >= 1 << (R_BITS - 1):
            raise ValueError("the modulus must be below 2^255")
        self.p = p
        self.device = torch.device(device)
        self.R = (1 << R_BITS) % p
        self.R2 = (1 << (2 * R_BITS)) % p
        self.R_inv = pow(1 << R_BITS, -1, p)
        self.n0 = (-pow(p, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)
        self.p_limbs = torch.tensor(int_to_limbs(p), dtype=torch.int64, device=self.device)

    # -- moving values in and out ------------------------------------------

    def raw(self, values) -> torch.Tensor:
        """Python ints in ``[0, p)`` -> their limbs, as they are (no Montgomery
        conversion): ``(16, n)``."""
        return torch.from_numpy(ints_to_limb_array(values)).to(self.device)

    def from_ints(self, values) -> torch.Tensor:
        """Python ints -> ``(16, n)`` Montgomery form."""
        reduced = [int(v) % self.p for v in values]
        return self.mul(self.raw(reduced), self.raw([self.R2]))

    def const(self, value: int, ndim: int = 1) -> torch.Tensor:
        """One element in Montgomery form, shaped ``(16, 1, ...)`` with ``ndim``
        unit axes, to broadcast over a batch of that many axes."""
        return self.raw([int(value) % self.p * self.R % self.p]).view((LIMBS,) + (1,) * ndim)

    def to_ints(self, a: torch.Tensor) -> list[int]:
        """Montgomery form, any batch shape -> Python ints in ``[0, p)``, in the
        batch's row-major order."""
        flat = a.reshape(LIMBS, -1)
        plain = self.mul(flat, self.raw([1]))
        return limb_array_to_ints(plain.cpu().numpy())

    def from_words(self, words: torch.Tensor) -> torch.Tensor:
        """``(n, 8)`` int32 words (little-endian 32-bit, bit patterns of uint32)
        -> ``(16, n)`` limbs of the same integers."""
        w = words.to(torch.int64) & 0xFFFFFFFF
        lo = w & MASK
        hi = w >> LIMB_BITS
        return torch.stack([lo, hi], dim=2).reshape(words.shape[0], LIMBS).T.contiguous()

    def to_words(self, limbs: torch.Tensor) -> torch.Tensor:
        """``(16, n)`` limbs -> ``(n, 8)`` int32 words."""
        pairs = limbs.T.reshape(-1, LIMBS // 2, 2)
        w = pairs[:, :, 0] | (pairs[:, :, 1] << LIMB_BITS)
        return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)

    # -- arithmetic -----------------------------------------------------------

    def _carry(self, t: torch.Tensor) -> torch.Tensor:
        """Propagate carries (or borrows) along the limb axis in place; the last
        row keeps what runs past it."""
        for i in range(t.shape[0] - 1):
            t[i + 1] += t[i] >> LIMB_BITS
        t[:-1] &= MASK
        return t

    def _reduce_once(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (17 limbs, normalised, value below 2p) -> ``t mod p`` (16 limbs)."""
        d = t.clone()
        d[:LIMBS] -= self.p_limbs.view((LIMBS,) + (1,) * (t.dim() - 1))
        self._carry(d)
        keep = d[LIMBS] < 0  # t < p
        return torch.where(keep, t[:LIMBS], d[:LIMBS])

    def _extend(self, t: torch.Tensor) -> torch.Tensor:
        return torch.cat([t, torch.zeros_like(t[:1])])

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a, b = torch.broadcast_tensors(a, b)
        return self._reduce_once(self._carry(self._extend(a + b)))

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a, b = torch.broadcast_tensors(a, b)
        d = self._carry(self._extend(a - b))
        low = d[LIMBS] < 0  # a < b: add p back
        e = d.clone()
        e[:LIMBS] += self.p_limbs.view((LIMBS,) + (1,) * (d.dim() - 1))
        self._carry(e)
        return torch.where(low, e[:LIMBS], d[:LIMBS])

    def mul(self, a: torch.Tensor, b: torch.Tensor, reduce: bool = True) -> torch.Tensor:
        """Montgomery product ``a b / R mod p``. ``reduce=False`` leaves out the
        final conditional subtraction: the result is below 2p, not canonical."""
        shape = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
        t = torch.zeros((2 * LIMBS + 1,) + tuple(shape), dtype=torch.int64, device=a.device)
        for i in range(LIMBS):
            t[i: i + LIMBS].addcmul_(a[i], b)
        p = self.p_limbs.view((LIMBS,) + (1,) * len(shape))
        for i in range(LIMBS):
            m = (t[i] * self.n0) & MASK  # t[i] < 2^38: no overflow
            t[i: i + LIMBS].addcmul_(m, p)
            t[i + 1] += t[i] >> LIMB_BITS
        high = self._carry(t[LIMBS:])
        return self._reduce_once(high) if reduce else high[:LIMBS]

    # -- multilinear helpers (index bit 0 is the most significant) -----------

    def fold(self, table: torch.Tensor, r: int) -> torch.Tensor:
        """Bind the first (most significant) variable of the tables along the
        last axis to ``r``: ``lo + r (hi - lo)``."""
        half = table.shape[-1] // 2
        lo, hi = table[..., :half], table[..., half:]
        return self.add(lo, self.mul(self.sub(hi, lo), self.const(r, table.dim() - 1)))

    def evaluate(self, table: torch.Tensor, point: list[int]) -> int:
        """The multilinear extension of ``table`` (last axis) at ``point``."""
        for r in point:
            table = self.fold(table, r)
        (value,) = self.to_ints(table)
        return value

    def eq_table(self, point: list[int]) -> torch.Tensor:
        """eq(point, x) for every x of the hypercube, ``(16, 2^k)``; point[0]
        is the most significant bit of x."""
        table = self.const(1)
        for r in point:
            lo = self.mul(table, self.const(1 - r))
            hi = self.mul(table, self.const(r))
            table = torch.stack([lo, hi], dim=-1).reshape(LIMBS, -1)
        return table

    def sum_int(self, a: torch.Tensor) -> list[int]:
        """Sums over the last axis of a Montgomery batch -> Python ints, one per
        leading batch index."""
        sums = a.reshape(LIMBS, -1, a.shape[-1]).sum(dim=-1).cpu().numpy()
        out = []
        for j in range(sums.shape[1]):
            total = sum(int(sums[i, j]) << (LIMB_BITS * i) for i in range(LIMBS))
            out.append(total * self.R_inv % self.p)
        return out

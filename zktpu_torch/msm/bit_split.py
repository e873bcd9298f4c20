"""Bit-split MSM: sum_i s_i * P_i = sum_b 2^b * (sum over {i : bit b(s_i)} P_i).

The counterpart of ``zktpu/msm/bit_split.py``'s ``msm_bitsplit``: the inner sum
is a masked tree reduction (log2(n) batched point additions at halving widths,
all 255 bits side by side), and the 2^b factors collapse into a single width-1
Horner double chain over the 255 scalar bits. It shares no stage with the Pippenger
MSM, which is why it is kept: the two are crossed in the tests and on the card.
(The JAX package also has a batched variant with per-segment bases, there to
save compiles; it has no counterpart.)

Masking is free: infinity is encoded as Z == 0, so "exclude point" is just
zeroing its Z.
"""

from __future__ import annotations

import torch

from ..curve import device as dc

SCALAR_BITS = dc.SCALAR_BITS


def msm_bitsplit(points, scalars):
    """MSM over a Jacobian (n, 12) triple and canonical (n, 8) Fr scalars;
    returns a single Jacobian point as a triple of (12,) coordinates.

    All 255 masked copies of the batch are reduced side by side, one launch a
    tree level at 255 times the level's width, so the whole costs log2(n) wide
    additions and the 510 single-lane steps of the Horner chain. It holds
    255 * n points at once: a check for small batches, not a production MSM."""
    X, Y, Z = points
    n = X.shape[0]
    shifts = torch.arange(SCALAR_BITS, dtype=torch.int32, device=scalars.device)
    # bits[i, b] = bit b of scalar i
    bits = ((scalars[:, shifts // 32] >> (shifts % 32)) & 1).bool()
    masked = tuple(v[:, None, :].expand(n, SCALAR_BITS, -1) for v in (X, Y))
    masked += (torch.where(bits[:, :, None], Z[:, None, :], torch.zeros_like(Z[:, None, :])),)
    per_bit = dc.tree_sum_points(masked)  # (255, 12) triple
    acc = dc.infinity_like((1,), scalars.device)
    for bit_index in range(SCALAR_BITS - 1, -1, -1):
        acc = dc.point_add(
            dc.point_double(acc),
            tuple(v[bit_index: bit_index + 1].contiguous() for v in per_bit),
        )
    return tuple(v[0] for v in acc)


def msm_bitsplit_host(affine_points, scalar_ints, device=None):
    """Host points/ints in, host affine point out (test convenience)."""
    pts = dc.pack_points(affine_points, device)
    out = msm_bitsplit(pts, dc.pack_scalars(scalar_ints, device))
    return dc.unpack_points(tuple(t[None] for t in out))[0]

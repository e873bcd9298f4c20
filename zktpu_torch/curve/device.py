"""BLS12-381 G1 arithmetic on the device over word tensors.

The counterpart of ``zktpu/curve/device.py`` (and of what ``lm_point.py`` adds to
it): the group-operation layer under the Lagrange-SRS construction and the MSMs.

Representation: a batch of Jacobian points is a triple ``(X, Y, Z)`` of
contiguous int32 ``(..., 12)`` Montgomery word tensors over Fq on one device;
the point at infinity is ``Z == 0``. Scalars are canonical (non-Montgomery) Fr
words, ``(..., 8)`` int32. Every group operation goes through
``point_kernels.point_add`` / ``point_double``: the CUDA kernels for tensors on
the card, their plain versions for tensors on the CPU. The field contexts are
taken from the tensors' device, so nothing here decides where the work runs.
BLS12-381 G1 has no 2-torsion (its order is odd), so the Y == 0 doubling edge
cannot occur.
"""

from __future__ import annotations

import torch

from ..field import kernels as fk
from ..field import torch_backend as fb
from ..field.spec import BLS12_381_FQ, BLS12_381_FR
from . import bls12_381 as host_curve
from . import point_kernels as pk

SCALAR_BITS = 255


def fq_ctx(device=None):
    """The Fq context of ``device`` (``None``: the card, or it raises)."""
    return fb.get_ctx(BLS12_381_FQ, device)


def fr_ctx(device=None):
    return fb.get_ctx(BLS12_381_FR, device)


# ----------------------------------------------------------------------
# host <-> device conversion
# ----------------------------------------------------------------------

def pack_points(affine_points, device=None) -> tuple:
    """List of host affine points ((x, y) FQ pairs or None) -> Jacobian words."""
    ctx = fq_ctx(device)
    xs, ys, zs = [], [], []
    for pt in affine_points:
        if pt is None:
            xs.append(0), ys.append(1), zs.append(0)
        else:
            xs.append(int(pt[0].n)), ys.append(int(pt[1].n)), zs.append(1)
    return tuple(fk.to_mont(ctx, ctx.to_device(ctx.pack(v))) for v in (xs, ys, zs))


def unpack_points(jac) -> list:
    """Jacobian word tensors -> list of host affine points (None = infinity).

    One modular inverse a point on the host: meant for the few points of a
    proof, never for a basis."""
    ctx = fq_ctx(jac[0].device)
    xs, ys, zs = (
        ctx.unpack(fk.from_mont(ctx, t.reshape(-1, ctx.num_words).contiguous())) for t in jac
    )
    out = []
    p = BLS12_381_FQ.modulus
    for x, y, z in zip(xs, ys, zs):
        x, y, z = int(x), int(y), int(z)
        if z == 0:
            out.append(None)
            continue
        zinv = pow(z, -1, p)
        zinv2 = zinv * zinv % p
        out.append((host_curve.FQ(x * zinv2 % p), host_curve.FQ(y * zinv2 * zinv % p)))
    return out


def pack_scalars(values, device=None):
    """Host ints -> canonical (non-Montgomery) Fr words on the device."""
    ctx = fr_ctx(device)
    return ctx.to_device(ctx.pack([int(v) % BLS12_381_FR.modulus for v in values]))


def infinity_like(shape_prefix, device=None) -> tuple:
    """(X, Y, Z) = (0, 1, 0) over a batch of shape ``shape_prefix``."""
    ctx = fq_ctx(device)
    shape = tuple(shape_prefix) + (ctx.num_words,)
    zero = torch.zeros(shape, dtype=torch.int32, device=ctx.device)
    return (zero, ctx.one_mont.expand(shape).contiguous(), zero.clone())


# ----------------------------------------------------------------------
# point operations
# ----------------------------------------------------------------------

def point_add(p1, p2):
    """Complete Jacobian addition, lane by lane (kernel on the card)."""
    return pk.point_add(fq_ctx(p1[0].device), p1, p2)


def point_double(pt):
    return pk.point_double(fq_ctx(pt[0].device), pt)


def where_pt(mask, a, b):
    """Per-lane select over (X, Y, Z) triples; ``mask`` has the batch's shape."""
    m = mask[..., None]
    return tuple(torch.where(m, x, y) for x, y in zip(a, b))


def gather_pt(pt, idx):
    """Lanes ``idx`` of a batch whose lanes run along axis 0."""
    return tuple(v[idx] for v in pt)


def scalar_bit(scalars, bit_index: int):
    """Bit ``bit_index`` of canonical scalar words, as a bool per lane."""
    word = scalars[..., bit_index // 32]
    return ((word >> (bit_index % 32)) & 1).bool()


def batch_scalar_mul(points, scalars):
    """Per-lane scalar multiplication: out[i] = scalars[i] * points[i].

    The 255-step double-and-add ladder (MSB first): every step is one batched
    doubling and one batched addition across all lanes, two launches."""
    acc = infinity_like(scalars.shape[:-1], scalars.device)
    for bit_index in range(SCALAR_BITS - 1, -1, -1):
        acc = point_double(acc)
        acc = where_pt(scalar_bit(scalars, bit_index), point_add(acc, points), acc)
    return acc


def tree_sum_points(jac):
    """Sum points along axis 0 by log-depth pairwise addition."""
    X, Y, Z = jac
    n = X.shape[0]
    while n > 1:
        half = n // 2
        lo = tuple(t[:half].contiguous() for t in (X, Y, Z))
        hi = tuple(t[half: 2 * half].contiguous() for t in (X, Y, Z))
        red = point_add(lo, hi)
        if n % 2:
            red = tuple(torch.cat([r, t[2 * half:]]) for r, t in zip(red, (X, Y, Z)))
        X, Y, Z = red
        n = X.shape[0]
    return (X[0], Y[0], Z[0])


def msm(points, scalars):
    """Multi-scalar multiplication by the batched ladder and a tree sum: the
    simplest of the strategies, kept as the independent check of the others."""
    return tree_sum_points(batch_scalar_mul(points, scalars))


def msm_host(affine_points, scalar_ints, device=None):
    """Host points/ints in, host affine point out."""
    out = msm(pack_points(affine_points, device), pack_scalars(scalar_ints, device))
    return unpack_points(tuple(t[None] for t in out))[0]


def batch_generator_mul(scalars):
    """scalars[i] * G1 for every lane by the ladder: the independent check of
    the fixed-base comb."""
    n = scalars.shape[0]
    gen = pack_points([host_curve.G1_GEN], scalars.device)
    rep = tuple(t.expand(n, -1).contiguous() for t in gen)
    return batch_scalar_mul(rep, scalars)

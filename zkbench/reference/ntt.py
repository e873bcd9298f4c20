"""The plain reference of the radix-2 NTT (the Rust reference's fft/src/fft.rs)
on a table of field words.

The forward transform of a_0..a_{n-1} is A_j = sum_i a_i w^(i j), w the n-th
root of unity of the field (its two-adic generator squared down); the inverse
is the transform at w^-1, scaled by n^-1. Both are linear, so they act on
table words alike whether the words are read as plain or Montgomery values.
Computed as the iterative Cooley-Tukey transform: bit-reversed order, then one
butterfly stage a doubling of the span.
"""

from __future__ import annotations

import torch

from .field import LIMBS, PrimeField


def root_of_unity(p: int, generator: int, two_adicity: int, log_n: int) -> int:
    root = pow(generator, (p - 1) >> two_adicity, p)
    for _ in range(two_adicity - log_n):
        root = root * root % p
    return root


def _bitrev(log_n: int, device) -> torch.Tensor:
    i = torch.arange(1 << log_n, device=device)
    rev = torch.zeros_like(i)
    for b in range(log_n):
        rev |= ((i >> b) & 1) << (log_n - 1 - b)
    return rev


def _powers(F: PrimeField, w: int, count: int) -> torch.Tensor:
    """w^0 .. w^(count-1), Montgomery, by doubling."""
    table = F.const(1)
    while table.shape[-1] < count:
        step = pow(w, table.shape[-1], F.p)
        table = torch.cat([table, F.mul(table, F.const(step))], dim=-1)
    return table[:, :count]


def _lazy_butterfly(F: PrimeField, u: torch.Tensor, v: torch.Tensor):
    """u + v and u - v + p, left in [0, 2p): equal to the butterfly's outputs
    modulo p, but not reduced."""
    p = F.p_limbs.view((LIMBS,) + (1,) * (u.dim() - 1))
    return F._carry(u + v)[:LIMBS], F._carry(F._extend(u - v + p))[:LIMBS]


def transform(F: PrimeField, x: torch.Tensor, root: int, reduce_last: bool = True) -> torch.Tensor:
    """The transform of the ``(16, n)`` limbs ``x`` at ``root``.
    ``reduce_last=False`` leaves the last stage's outputs unreduced (below
    2p): the control, whose words are not all canonical."""
    n = x.shape[-1]
    log_n = n.bit_length() - 1
    x = x[:, _bitrev(log_n, x.device)]
    twiddles = _powers(F, root, max(1, n // 2))
    for s in range(1, log_n + 1):
        m = 1 << s
        half = m // 2
        blocks = x.reshape(LIMBS, n // m, 2, half)
        w = twiddles[:, :: n // m][:, None, :half]
        v = F.mul(blocks[:, :, 1], w)
        u = blocks[:, :, 0]
        if reduce_last or s < log_n:
            pair = (F.add(u, v), F.sub(u, v))
        else:
            pair = _lazy_butterfly(F, u, v)
        x = torch.stack(pair, dim=2).reshape(LIMBS, n)
    return x


def ntt_words(F: PrimeField, words: torch.Tensor, generator: int, two_adicity: int,
              inverse: bool = False, reduce_last: bool = True) -> torch.Tensor:
    """The transform of a ``(n, 8)`` int32 word table -> ``(n, 8)`` words."""
    n = words.shape[0]
    log_n = n.bit_length() - 1
    root = root_of_unity(F.p, generator, two_adicity, log_n)
    if inverse:
        root = pow(root, -1, F.p)
    out = transform(F, F.from_words(words), root, reduce_last)
    if inverse:
        out = F.mul(out, F.const(pow(n, -1, F.p)), reduce=reduce_last)
    return F.to_words(out)

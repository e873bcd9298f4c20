"""Lazy f(b,c) sumcheck for GKR: linear-time phase tables instead of dense
wiring tensors.

The counterpart of ``zktpu/gkr/lazy.py``. The reference materializes, per
layer, (a) the one-hot wiring MLE add_i/mul_i over 2^(log n + 2 log n + 2)
entries (gkr_circuit.rs:39-52) and (b) the O(|w|^2) tensor w(b) op w(c)
(multilinear_polynomial_evaluation.rs:99-110). Both are exponential cliffs: a
2^20-gate layer would need a 2^62-entry table.

This module exploits the structure the reference's own wiring admits (gate a
always reads b = 2a, c = 2a+1): add_i(a,b,c) = sum_{g in add} eq(a, g)
* onehot(b = 2g) * onehot(c = 2g+1). Binding a to the verifier challenges
collapses each gate to a single coefficient, and summing over c (phase 1) or
binding b (phase 2) leaves O(|w|)-size tables:

  phase 1 (binding b):  sum_c f(b,c) = w(b) * G(b) + H(b)
      G[2g] = coefA_g + coefM_g * w[2g+1],  H[2g] = coefA_g * w[2g+1]
      (odd entries 0), where coefA_g / coefM_g are the bound-a wiring
      coefficients per gate.
  phase 2 (binding c, b bound to r_b):  f(r_b, c) = A2(c) * (wb + w(c))
      + (M2(c) * wb) * w(c), with A2[2g+1] = coefA_g * eq(r_b, 2g) and
      M2 likewise (even entries 0).

Summation over the hypercube commutes with partial evaluation, and every step
is exact field arithmetic, so each round polynomial is the *identical field
element sequence* the dense-tensor prover emits -- proof bytes match bit for
bit. Total prover work per layer drops from O(|w|^2) to O(|w|) field ops.

On the device: every whole-table product goes through the ``mont_mul`` kernel
(table x table, or table x one element), every fold through the ``fold``
kernel, and phase 2's round evaluations through the ``gkr_round`` kernel.
Modular additions, selects and interleaves are plain tensor operations.
"""

from __future__ import annotations

import torch

from ..field import kernels as fk
from ..field import torch_backend as fb
from ..field.torch_backend import FieldCtx
from ..poly.multilinear import MultilinearPoly
from ..poly.univariate import UnivariatePoly
from ..sumcheck.protocol import (
    GkrSumcheckProof,
    _encode,
    _to_ints,
    fold_tables_kernel,
)
from ..transcript import Transcript
from .circuit import Layer


def _interleave(first, second):
    """(n, W), (n, W) -> (2n, W): first at the even rows, second at the odd."""
    return torch.stack([first, second], dim=1).reshape(2 * first.shape[0], first.shape[1])


def eq_tensor(ctx: FieldCtx, values_mont):
    """eq(r, x) table over all 2^k MSB-first hypercube vertices x.

    Chain of kron products of (1 - r_i, r_i); challenge 0 lands on the most
    significant index bit, matching the reference's bit packing
    (gkr_circuit.rs:67-104) and ``generate_bhc`` enumeration (kzg.rs:171-181).
    ``values_mont``: a list of (W,) or a (k, W) tensor of Montgomery words. Each
    doubling is two ``mont_mul`` launches (table x one element) and an
    interleave.
    """
    table = ctx.one_mont[None]
    if len(values_mont) == 0:
        return table
    rs = values_mont if isinstance(values_mont, torch.Tensor) else torch.stack(list(values_mont))
    one_minus = fb.sub(ctx, ctx.one_mont, rs)
    for k in range(rs.shape[0]):
        table = _interleave(
            fk.mont_mul(ctx, table, one_minus[k]), fk.mont_mul(ctx, table, rs[k])
        )
    return table  # (2^k, W) Montgomery


def _phase1_tables_kernel(ctx: FieldCtx, coef_a, coef_m, w_table):
    """Interleaved G/H tables over b from per-gate coefficients.

    coef_a/coef_m: (n, W) bound-a wiring coefficients; w_table: (2n, W).
    Returns (2, 2n, W): [G, H] with G[2g] = coefA_g + coefM_g * w[2g+1],
    H[2g] = coefA_g * w[2g+1], odd entries zero.
    """
    n = coef_a.shape[0]
    w_odd = w_table.reshape(n, 2, ctx.num_words)[:, 1].contiguous()
    h_even = fk.mont_mul(ctx, coef_a, w_odd)
    g_even = fb.add(ctx, coef_a, fk.mont_mul(ctx, coef_m, w_odd))
    zeros = torch.zeros_like(g_even)
    return torch.stack([_interleave(g_even, zeros), _interleave(h_even, zeros)])


def _phase2_tables_kernel(ctx: FieldCtx, coef_a, coef_m, w_table, eqb, wb):
    """Phase-2 SumPoly tables over c once b is bound to r_b.

    Returns a contiguous (2, 2, 2n, W) stack in ``gkr_round`` layout:
    [[A2, wb + w], [M2 * wb, w]] with A2[2g+1] = coefA_g * eq(r_b, 2g).
    """
    n = coef_a.shape[0]
    eqb_even = eqb.reshape(n, 2, ctx.num_words)[:, 0].contiguous()
    a2_odd = fk.mont_mul(ctx, coef_a, eqb_even)
    m2_odd = fk.mont_mul(ctx, fk.mont_mul(ctx, coef_m, eqb_even), wb)
    zeros = torch.zeros_like(a2_odd)
    a2 = _interleave(zeros, a2_odd)
    m2 = _interleave(zeros, m2_odd)
    wb_plus_w = fb.add(ctx, w_table, wb)
    return torch.stack([torch.stack([a2, wb_plus_w]), torch.stack([m2, w_table])])


def _phase1_round_kernel(ctx: FieldCtx, tables):
    """Round-poly evaluations y_t (t = 0,1,2) of sum_rest (F*G + H).

    ``tables``: (3, size, W) Montgomery stack [F, G, H]. Same field values as
    the dense partial_evaluate + reduce + sum at each t. Plain PyTorch.
    """
    half = tables.shape[1] // 2
    a = tables[:, :half]
    b = tables[:, half:]
    diff = fb.sub(ctx, b, a)

    ys = []
    two = fb.add(ctx, ctx.one_mont, ctx.one_mont)
    for t in range(3):
        if t == 0:
            vals = a
        elif t == 1:
            vals = b
        else:
            vals = fb.add(ctx, a, fb.mont_mul(ctx, two, diff))
        total = fb.add(ctx, fb.mont_mul(ctx, vals[0], vals[1]), vals[2])
        ys.append(fb.field_sum(ctx, total, axis=0))
    return torch.stack(ys)


class LazyFbc:
    """f(b,c) = add_i(r,b,c)*(w(b)+w(c)) + mul_i(r,b,c)*(w(b)*w(c)) held as
    per-gate coefficients + the w table; materializes only O(|w|) tables."""

    __slots__ = ("ctx", "coef_a", "coef_m", "w_table", "num_rounds")

    def __init__(self, ctx: FieldCtx, coef_a, coef_m, w_poly: MultilinearPoly):
        self.ctx = ctx
        self.coef_a = coef_a
        self.coef_m = coef_m
        self.w_table = w_poly.table
        if w_poly.table.shape[0] != 2 * coef_a.shape[0]:
            raise ValueError("w table must have 2 * n_gates entries")
        # (b, c) each carry log2(|w|) variables
        self.num_rounds = 2 * w_poly.num_vars

    def get_degree(self) -> int:
        return 2


def _gate_masks(ctx: FieldCtx, layer: Layer):
    """Montgomery-domain 0/1 masks for add and mul gates."""
    is_add = torch.from_numpy(layer.is_add()).to(ctx.device)[:, None]
    add_mask = torch.where(is_add, ctx.one_mont, ctx.zero)
    mul_mask = torch.where(is_add, ctx.zero, ctx.one_mont)
    return add_mask, mul_mask


def _require_pow2(layer: Layer):
    n = layer.n_gates
    if n & (n - 1):
        raise ValueError(
            "lazy fbc requires power-of-two layer sizes (the reference's "
            "bit packing is only well-formed there); use the dense path"
        )


def _masked_coefs(ctx: FieldCtx, layer: Layer, coef):
    """Split per-gate coefficients (n, W) into (add gates', mul gates')."""
    add_mask, mul_mask = _gate_masks(ctx, layer)
    return fk.mont_mul(ctx, coef, add_mask), fk.mont_mul(ctx, coef, mul_mask)


def _bound_a_coefs(ctx: FieldCtx, layer: Layer, random_challenge: int):
    """Layer-0 per-gate coefficients: eq over the 1-bit gate index at r."""
    n = layer.n_gates
    if n > 2:
        raise ValueError("output layer has more than 2 gates")
    eq_a = eq_tensor(ctx, [_encode(ctx, random_challenge)])[:n].contiguous()
    return _masked_coefs(ctx, layer, eq_a)


def _folded_coefs(ctx: FieldCtx, layer: Layer, r_b: list[int], r_c: list[int],
                  alpha: int, beta: int):
    """coef_g = alpha * eq(r_b, g) + beta * eq(r_c, g), masked per gate type."""
    n = layer.n_gates
    scalars = _encode(ctx, list(r_b) + list(r_c) + [alpha, beta])
    k = len(r_b)
    eq_rb = eq_tensor(ctx, scalars[:k])[:n].contiguous()
    eq_rc = eq_tensor(ctx, scalars[k : 2 * k])[:n].contiguous()
    folded = fb.add(
        ctx, fk.mont_mul(ctx, eq_rb, scalars[2 * k]), fk.mont_mul(ctx, eq_rc, scalars[2 * k + 1])
    )
    return _masked_coefs(ctx, layer, folded)


def lazy_fbc(ctx: FieldCtx, random_challenge: int, layer: Layer,
             w_poly: MultilinearPoly) -> LazyFbc:
    """Layer-0 fbc (reference get_fbc_poly, gkr_protocol.rs:243-263): the
    gate-index variable a (1 bit; the output layer has 1-2 gates) bound to r."""
    _require_pow2(layer)
    coef_a, coef_m = _bound_a_coefs(ctx, layer, random_challenge)
    return LazyFbc(ctx, coef_a, coef_m, w_poly)


def lazy_folded_fbc(ctx: FieldCtx, layer: Layer, w_poly: MultilinearPoly,
                    r_b: list[int], r_c: list[int], alpha: int,
                    beta: int) -> LazyFbc:
    """Folded fbc (reference get_folded_fbc_poly, gkr_protocol.rs:265-292):
    coef_g = alpha * eq(r_b, g) + beta * eq(r_c, g), masked per gate type."""
    _require_pow2(layer)
    n = layer.n_gates
    if len(r_b) != max(1, n.bit_length() - 1):
        raise ValueError("r_b width must match the layer's gate-index bits")
    coef_a, coef_m = _folded_coefs(ctx, layer, r_b, r_c, alpha, beta)
    return LazyFbc(ctx, coef_a, coef_m, w_poly)


def gkr_prove_lazy(claimed_sum: int, fbc: LazyFbc,
                   transcript: Transcript) -> GkrSumcheckProof:
    """Drop-in replacement for ``sumcheck.gkr_prove`` on a LazyFbc: identical
    transcript bytes, O(|w|) work per layer instead of O(|w|^2)."""
    ctx = fbc.ctx
    spec = ctx.spec
    nb = fbc.num_rounds // 2
    proof_polynomials = []
    random_challenges = []

    def finish_round(ys, tables):
        round_poly = UnivariatePoly.interpolate(spec, [(t, y) for t, y in enumerate(ys)])
        transcript.append_field_elements(round_poly.coefficients)
        proof_polynomials.append(round_poly)
        r = transcript.get_random_challenge()
        random_challenges.append(r)
        return fold_tables_kernel(ctx, tables, _encode(ctx, r))

    # ---- phase 1: bind b ------------------------------------------------
    gh = _phase1_tables_kernel(ctx, fbc.coef_a, fbc.coef_m, fbc.w_table)
    tables = torch.cat([fbc.w_table[None], gh])  # (3, 2n, W): F, G, H
    for _ in range(nb):
        tables = finish_round(_to_ints(ctx, _phase1_round_kernel(ctx, tables)), tables)

    wb = tables[0, 0]  # w(r_b)

    # ---- phase 2: bind c ------------------------------------------------
    eqb = eq_tensor(ctx, _encode(ctx, random_challenges))
    tables2 = _phase2_tables_kernel(ctx, fbc.coef_a, fbc.coef_m, fbc.w_table, eqb, wb)
    for _ in range(nb):
        ys = fk.lazy_rows_to_ints(ctx, fk.gkr_round(ctx, tables2))
        tables2 = finish_round(ys, tables2)

    return GkrSumcheckProof(proof_polynomials, claimed_sum, random_challenges)


# ----------------------------------------------------------------------
# analytic wiring-predicate evaluations for the verifier
# ----------------------------------------------------------------------

def _wiring_eval(ctx: FieldCtx, layer: Layer, coef_a, coef_m,
                 b_challenges: list[int], c_challenges: list[int]):
    """(add_i, mul_i) evaluated at bound (a -> coefs, b, c): each gate g
    contributes coef_g * eq(r_b, 2g) * eq(r_c, 2g+1)."""
    n = layer.n_gates
    k = len(b_challenges)
    scalars = _encode(ctx, list(b_challenges) + list(c_challenges))
    eqb_even = eq_tensor(ctx, scalars[:k])[: 2 * n].reshape(n, 2, ctx.num_words)[:, 0].contiguous()
    eqc_odd = eq_tensor(ctx, scalars[k:])[: 2 * n].reshape(n, 2, ctx.num_words)[:, 1].contiguous()
    weight = fk.mont_mul(ctx, eqb_even, eqc_odd)
    a_val = fb.field_sum(ctx, fk.mont_mul(ctx, coef_a, weight), axis=0)
    m_val = fb.field_sum(ctx, fk.mont_mul(ctx, coef_m, weight), axis=0)
    a_int, m_int = _to_ints(ctx, torch.stack([a_val, m_val]))
    return a_int, m_int


def verifier_claim_lazy(ctx: FieldCtx, layer: Layer, init_random_challenge: int,
                        sumcheck_challenges: list[int], o_1: int,
                        o_2: int) -> int:
    """Analytic get_verifier_claim (reference gkr_protocol.rs:294-314)."""
    _require_pow2(layer)
    coef_a, coef_m = _bound_a_coefs(ctx, layer, init_random_challenge)
    mid = len(sumcheck_challenges) // 2
    a_r, m_r = _wiring_eval(
        ctx, layer, coef_a, coef_m,
        list(sumcheck_challenges[:mid]), list(sumcheck_challenges[mid:]),
    )
    p = ctx.spec.modulus
    return (a_r * (o_1 + o_2) + m_r * (o_1 * o_2)) % p


def folded_verifier_claim_lazy(ctx: FieldCtx, layer: Layer,
                               current_challenges: list[int],
                               previous_challenges: list[int], o_1: int,
                               o_2: int, alpha: int, beta: int) -> int:
    """Analytic get_folded_verifier_claim (reference gkr_protocol.rs:316-341)."""
    _require_pow2(layer)
    mid = len(previous_challenges) // 2
    coef_a, coef_m = _folded_coefs(
        ctx, layer, previous_challenges[:mid], previous_challenges[mid:], alpha, beta
    )
    cur_mid = len(current_challenges) // 2
    a_r, m_r = _wiring_eval(
        ctx, layer, coef_a, coef_m,
        list(current_challenges[:cur_mid]), list(current_challenges[cur_mid:]),
    )
    p = ctx.spec.modulus
    return (a_r * (o_1 + o_2) + m_r * (o_1 * o_2)) % p

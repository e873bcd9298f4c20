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

This module builds a layer's ``LazyFbc`` (its wiring coefficients, one kernel
launch, ``gkr/tables.py``) and evaluates the wiring predicates for the
verifier, on whole eq tables (``eq_tensor``). The sumcheck over a ``LazyFbc``
runs in ``gkr/fused_lazy.py`` on one device and in
``parallel.mesh.gkr_sumcheck_lazy_sharded`` over a mesh; both build the phase
stacks with ``gkr/tables.py``.
"""

from __future__ import annotations

import torch

from ..field import kernels as fk
from ..field import torch_backend as fb
from ..field.torch_backend import FieldCtx
from ..poly.multilinear import MultilinearPoly
from ..sumcheck.protocol import _encode, _to_ints
from . import tables as gt
from .circuit import Layer
from .tables import eq_tensor


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


def _require_pow2(layer: Layer):
    n = layer.n_gates
    if n & (n - 1):
        raise ValueError(
            "lazy fbc requires power-of-two layer sizes (the reference's "
            "bit packing is only well-formed there); use the dense path"
        )


def _bound_a_coefs(ctx: FieldCtx, layer: Layer, random_challenge: int):
    """Layer-0 per-gate coefficients: eq over the 1-bit gate index at r."""
    n = layer.n_gates
    if n > 2:
        raise ValueError("output layer has more than 2 gates")
    r = _encode(ctx, [random_challenge])
    return gt.wiring_coefs(ctx, r.reshape(1, 1, ctx.num_words), None,
                           layer.add_mask(ctx.device), n)


def _folded_coefs(ctx: FieldCtx, layer: Layer, r_b: list[int], r_c: list[int],
                  alpha: int, beta: int):
    """coef_g = alpha * eq(r_b, g) + beta * eq(r_c, g), split per gate type;
    the challenges and alpha, beta go up in one upload."""
    k = len(r_b)
    scalars = _encode(ctx, list(r_b) + list(r_c) + [alpha, beta])
    return gt.wiring_coefs(ctx, scalars[: 2 * k].reshape(2, k, ctx.num_words),
                           scalars[2 * k :], layer.add_mask(ctx.device), layer.n_gates)


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

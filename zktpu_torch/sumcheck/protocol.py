"""Sumcheck protocols: plain (single MLE) and the GKR composed-poly variant.

The counterpart of ``zktpu/sumcheck/protocol.py`` (capability parity with the
reference's sum_check_protocol.rs):
  * ``prove``/``verify``         (:25-84)  -- non-interactive sumcheck, 2-point
    round polys, final oracle evaluation.
  * ``gkr_prove``/``gkr_verify`` (:86-150) -- sumcheck over a SumPoly with an
    externally-owned transcript; degree-d round polys via Lagrange
    interpolation (:152-166).

The Fiat-Shamir squeeze makes rounds inherently serial, so the round loop runs
on the host while each round's O(2^n) work runs on the device. Plain sumcheck:
the half-sums as a modular tree in plain PyTorch, the fold through the ``fold``
kernel. GKR: the f(b,c) shape (two products of two factors, degree 2) takes its
three round evaluations from the ``gkr_round`` kernel and folds the whole
(2, 2, size, W) stack with one ``fold`` launch, at every table size; any other
shape goes through the general plain ``gkr_round_kernel``. Transcript bytes are
identical to the reference's (coefficients / half-sums serialized via
fq_vec_to_bytes). ``sumcheck.fused.prove`` gives the plain proof without the
per-round host round trip.
"""

from __future__ import annotations

import dataclasses

import torch

from ..field import kernels as fk
from ..field import torch_backend as fb
from ..field.torch_backend import FieldCtx
from ..poly.composed import SumPoly
from ..poly.multilinear import MultilinearPoly, halves_sum
from ..poly.univariate import UnivariatePoly
from ..transcript import Transcript
from ..utils import tracker


@dataclasses.dataclass
class Proof:
    """Plain-sumcheck proof (reference :8-12)."""

    proof_polynomials: list[list[int]]
    claimed_sum: int


@dataclasses.dataclass
class GkrSumcheckProof:
    """Composed-poly sumcheck proof (reference GkrProof, :13-17)."""

    proof_polynomials: list[UnivariatePoly]
    claimed_sum: int
    random_challenges: list[int]


@dataclasses.dataclass
class GkrVerifyResult:
    verified: bool
    final_claimed_sum: int
    random_challenges: list[int]


def gkr_round_kernel(ctx: FieldCtx, tables, degree: int):
    """Round-poly evaluations of a sum of products, any shape (plain PyTorch).

    ``tables``: (P, F, size, W) Montgomery tables (P products of F factors each,
    equal sizes). Returns ``ys`` of shape (degree+1, W): y_t = sum over the
    half-cube of sum_p prod_f (a + t*(b-a)), identical field values to the
    reference's partial_evaluate + reduce + sum at each t (:157-162).
    """
    n_products, n_factors, size, _ = tables.shape
    half = size // 2
    a = tables[:, :, :half]
    b = tables[:, :, half:]
    diff = fb.sub(ctx, b, a)

    ys = []
    t_mont = ctx.zero
    for t in range(degree + 1):
        if t == 0:
            vals = a
        elif t == 1:
            vals = b
        else:
            vals = fb.add(ctx, a, fb.mont_mul(ctx, t_mont, diff))
        prod = vals[:, 0]
        for f in range(1, n_factors):
            prod = fb.mont_mul(ctx, prod, vals[:, f])
        total = prod[0]
        for p in range(1, n_products):
            total = fb.add(ctx, total, prod[p])
        ys.append(fb.field_sum(ctx, total, axis=0))
        t_mont = fb.add(ctx, t_mont, ctx.one_mont)
    return torch.stack(ys)


def fold_tables_kernel(ctx: FieldCtx, tables, value):
    """Fold variable 0 of every table at once. tables: (..., size, W)."""
    return fk.fold(ctx, tables, value)


# ----------------------------------------------------------------------
# helpers
# ----------------------------------------------------------------------

def _to_ints(ctx: FieldCtx, mont_rows) -> list[int]:
    vals = ctx.unpack(fk.from_mont(ctx, mont_rows))
    return [int(v) for v in vals.reshape(-1)]


def _encode(ctx: FieldCtx, value: int) -> torch.Tensor:
    return fk.to_mont(ctx, ctx.to_device(ctx.pack(value)))


def _sum_poly_tables(sum_poly: SumPoly):
    return torch.stack(
        [torch.stack([f.table for f in p.factors]) for p in sum_poly.products]
    )


# ----------------------------------------------------------------------
# plain sumcheck (reference :25-84)
# ----------------------------------------------------------------------

def prove(poly: MultilinearPoly) -> Proof:
    ctx = poly.ctx
    transcript = Transcript(ctx.spec, seed=poly.transcript_sponge())

    # counted here and in sum_mont, as the JAX package counts it
    tracker.count("add", max(0, poly.table.shape[0] - 1))
    (claimed_sum,) = _to_ints(ctx, poly.sum_mont())
    transcript.append_field_elements([claimed_sum])

    proof_polynomials = []
    table = poly.table
    for _ in range(poly.num_vars):
        halves = _to_ints(ctx, halves_sum(ctx, table))
        transcript.append_field_elements(halves)
        proof_polynomials.append(halves)

        r = transcript.get_random_challenge()
        table = fold_tables_kernel(ctx, table, _encode(ctx, r))

    return Proof(proof_polynomials, claimed_sum)


def verify(poly: MultilinearPoly, proof: Proof) -> bool:
    ctx = poly.ctx
    transcript = Transcript(ctx.spec, seed=poly.transcript_sponge())
    transcript.append_field_elements([proof.claimed_sum])

    p = ctx.spec.modulus
    expected_sum = proof.claimed_sum % p
    random_challenges = []
    for round_poly in proof.proof_polynomials:
        if sum(round_poly) % p != expected_sum:
            return False
        transcript.append_field_elements(round_poly)
        r = transcript.get_random_challenge()
        # expected = p0 + r * (p1 - p0)   (reference :73-74)
        expected_sum = (round_poly[0] + r * (round_poly[1] - round_poly[0])) % p
        random_challenges.append(r)

    # final oracle check on the original polynomial (reference :81-83)
    return poly.evaluate_int(random_challenges) == expected_sum


# ----------------------------------------------------------------------
# GKR-variant sumcheck (reference :86-166)
# ----------------------------------------------------------------------

def gkr_prove(
    claimed_sum: int, composed_polynomial: SumPoly, transcript: Transcript
) -> GkrSumcheckProof:
    ctx = composed_polynomial.ctx
    spec = ctx.spec
    num_rounds = composed_polynomial.products[0].factors[0].num_vars
    degree = composed_polynomial.get_degree()

    tables = _sum_poly_tables(composed_polynomial)
    proof_polynomials = []
    random_challenges = []

    for _ in range(num_rounds):
        n_products, n_factors, size, _ = tables.shape
        half = size // 2
        # lerp muls for t >= 2, product muls, adds for sums + lerps
        tracker.count(
            "mul",
            (degree - 1) * n_products * n_factors * half
            + (degree + 1) * (n_factors - 1) * n_products * half,
        )
        tracker.count("add", (degree + 1) * n_products * half)
        if degree == 2 and (n_products, n_factors) == (2, 2):
            ys = fk.lazy_rows_to_ints(ctx, fk.gkr_round(ctx, tables))
        else:
            ys = _to_ints(ctx, gkr_round_kernel(ctx, tables, degree))
        round_poly = UnivariatePoly.interpolate(
            spec, [(t, y) for t, y in enumerate(ys)]
        )
        transcript.append_field_elements(round_poly.coefficients)
        proof_polynomials.append(round_poly)

        r = transcript.get_random_challenge()
        random_challenges.append(r)
        tracker.count("mul", tables.numel() // tables.shape[-1] // 2)
        tables = fold_tables_kernel(ctx, tables, _encode(ctx, r))

    return GkrSumcheckProof(proof_polynomials, claimed_sum, random_challenges)


def gkr_verify(
    round_polys: list[UnivariatePoly], claimed_sum: int, transcript: Transcript, spec
) -> GkrVerifyResult:
    p = spec.modulus
    claimed = claimed_sum % p
    random_challenges = []

    for round_poly in round_polys:
        f0 = round_poly.evaluate(0)
        f1 = round_poly.evaluate(1)
        if (f0 + f1) % p != claimed:
            return GkrVerifyResult(False, 0, [0])

        transcript.append_field_elements(round_poly.coefficients)
        r = transcript.get_random_challenge()
        random_challenges.append(r)
        claimed = round_poly.evaluate(r)

    return GkrVerifyResult(True, claimed, random_challenges)

"""Plain sumcheck over a single MLE: host-loop prover and verifier.

The counterpart of the plain half of ``zktpu/sumcheck/protocol.py`` (``Proof``,
``fold_tables_kernel``, ``prove``, ``verify``; capability parity with the
reference's sum_check_protocol.rs:25-84). The GKR composed-polynomial variant of
that module belongs to a later part of the port.

The Fiat-Shamir squeeze makes rounds inherently serial, so the round loop runs
on the host while each round's O(2^n) work runs on the device: the half-sums as
a modular tree in plain PyTorch, the fold through the ``fold`` kernel.
Transcript bytes are identical to the reference's (half-sums serialized via
fq_vec_to_bytes). ``sumcheck.fused.prove`` gives the same proof without the
per-round host round trip.
"""

from __future__ import annotations

import dataclasses

import torch

from ..field import kernels as fk
from ..field.torch_backend import FieldCtx
from ..poly.multilinear import MultilinearPoly, halves_sum
from ..transcript import Transcript
from ..utils import tracker


@dataclasses.dataclass
class Proof:
    """Plain-sumcheck proof (reference :8-12)."""

    proof_polynomials: list[list[int]]
    claimed_sum: int


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

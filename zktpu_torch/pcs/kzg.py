"""Multilinear KZG polynomial commitment over BLS12-381.

The counterpart of ``zktpu/pcs/kzg.py`` (capability parity with the reference's
pcs/src/kzg_pcs/kzg.rs):

  * trusted setup: Lagrange-basis SRS {G1 * eq_x(tau)} for every hypercube
    vertex x (:35-49, :183-212) and g2_taus = {G2 * tau_i} (:43-46);
  * ``commit`` = MSM of the evaluation table against the Lagrange basis
    (:51-53, :131-144);
  * ``open`` = plain evaluation (:55-57);
  * ``get_proof``: per variable, quotient q = f|_{x0=1} - f|_{x0=0} committed,
    then f <- f|_{x0=value} (:59-95);
  * ``verify``: pairing check e(C - v*G1, G2) == prod_i e(Q_i, tau_i*G2 -
    a_i*G2) (:97-128).

The eq_x(tau) table is built on the device as a chain of tensor products (one
per variable, MSB-first), the SRS comes from the fixed-base comb, every MSM is
the Pippenger MSM whatever its size, and only the verifier's pairings run on the
host.

Quotient commitments. The reference blows each quotient back up to 2^n entries
by tiling and commits it against the full basis: n MSMs of 2^n points. Because
tiling just repeats the quotient, commit(tile(q_k)) == MSM(q_k, C_k) with
C_k[y] = sum_j L[j * |q_k| + y], and the C_k form a halving chain of point
additions (C_{k+1} = C_k[:m] + C_k[m:]). ``get_proof`` therefore commits
quotient k, untiled (2^(n-1-k) entries), against ``collapsed_bases()[k]``: MSMs
of total size 2^n - 1 an opening, and the same group elements. (The JAX package
tiles every quotient up to 2^(n-1) entries and commits all of them against the
once-collapsed basis in one dispatch, which its compiler makes the cheap form;
that is n * 2^(n-1) scalar-point pairs an opening.) The two openings of a GKR
input proof share each step's basis: one batched MSM of two segments a step.

With ``utils.tracker`` recording, ``setup`` opens a ``kzg.srs`` span (inside
it ``kzg.srs.eq``, ``kzg.srs.comb``, ``kzg.srs.g2``), ``open`` a ``kzg.open``,
``commit`` a ``kzg.commit_msm`` and a ``kzg.unpack``, and the quotient path a
``kzg.quotients`` an opening, one ``kzg.quotient_msms`` and a ``kzg.unpack``.

Under an active mesh (``parallel.context.use_mesh``) the commitment MSM runs
point-sharded (``parallel.mesh.msm_pippenger_sharded``) and each quotient step
segment-sharded (``msm_pippenger_multi_sharded``), wherever each slot gets at
least ``MIN_ROWS_PER_DEVICE`` points: the same group elements.
"""

from __future__ import annotations

import dataclasses
import secrets

import torch

from ..curve import bls12_381 as hc
from ..curve import device as dc
from ..field import kernels as fk
from ..field import torch_backend as fb
from ..field.spec import BLS12_381_FR
from ..msm import generator_comb_mul
from ..msm.pippenger import msm_pippenger, msm_pippenger_multi, msm_pippenger_multi_batches
from ..parallel import context as pctx
from ..parallel import mesh as pm
from ..poly.multilinear import MultilinearPoly, tensor_op
from ..utils import tracker

FR = BLS12_381_FR


def random_taus(num_vars: int) -> list[int]:
    """Fresh-entropy taus, the reference's StdRng::from_entropy equivalent
    (gkr/src/gkr_protocol.rs:94-101)."""
    return [secrets.randbelow(FR.modulus - 1) + 1 for _ in range(num_vars)]


def eq_table_device(taus: list[int], device=None):
    """eq_x(tau) for all 2^n MSB-first hypercube vertices x, (2^n, 8) Montgomery
    words on the device: a chain of tensor products with (1 - tau_i, tau_i)."""
    ctx = fb.get_ctx(FR, device)
    p = FR.modulus
    pairs = fk.to_mont(
        ctx, ctx.to_device(ctx.pack([[(1 - tau) % p, tau % p] for tau in taus]))
    )
    table = ctx.one_mont[None]
    for k in range(len(taus)):
        table = tensor_op(ctx, table, pairs[k], "mul")
    return table


@dataclasses.dataclass
class KZG:
    """SRS holder. ``g1_lagrange_basis``: Jacobian triple (X, Y, Z) of (2^n, 12)
    word tables on the device; ``g2_taus``: host G2 affine points."""

    g1_lagrange_basis: tuple
    g2_taus: list
    num_vars: int
    #: halving chain of collapsed bases for quotient commitments (lazy)
    _collapsed: list | None = dataclasses.field(default=None, repr=False)

    @classmethod
    def setup(cls, num_vars: int, taus: list[int] | None = None, device=None) -> "KZG":
        """``device=None`` means the card (it raises where there is none)."""
        if num_vars < 1:
            raise ValueError("Invalid num of vars for lagrange basis")
        if taus is None:
            taus = random_taus(num_vars)
        if len(taus) != num_vars:
            raise ValueError("invalid taus or polynomials")
        ctx = fb.get_ctx(FR, device)
        with tracker.span("kzg.srs"):
            with tracker.span("kzg.srs.eq"):
                scalars = fk.from_mont(ctx, eq_table_device(taus, ctx.device))  # canonical
            with tracker.span("kzg.srs.comb"):
                basis = generator_comb_mul(scalars)
            with tracker.span("kzg.srs.g2"):
                g2_taus = [hc.multiply(hc.G2_GEN, t) for t in taus]
        return cls(basis, g2_taus, num_vars)

    @classmethod
    def for_poly(cls, polynomial: MultilinearPoly, taus: list[int]) -> "KZG":
        """Reference ``KZG::new(poly, taus)`` shape check (:18-33); the SRS lives
        where the polynomial does."""
        if len(taus) != polynomial.num_vars:
            raise ValueError("invalid taus or polynomials")
        return cls.setup(polynomial.num_vars, taus, polynomial.ctx.device)

    # ------------------------------------------------------------------

    def _check_poly(self, poly: MultilinearPoly) -> None:
        if poly.table.shape[0] != self.g1_lagrange_basis[0].shape[0]:
            raise ValueError("invalid polynomial or lagrange basis")

    def commit(self, poly: MultilinearPoly):
        """Pippenger MSM of the evaluation table against the Lagrange basis,
        point-sharded under an active mesh whose slots it gives enough rows."""
        self._check_poly(poly)
        with tracker.span("kzg.commit_msm"):
            scalars = fk.from_mont(poly.ctx, poly.table)
            mesh = pctx.current_mesh()
            if mesh is not None and pctx.shardable(scalars.shape[0], mesh):
                jac = pm.msm_pippenger_sharded(mesh, self.g1_lagrange_basis, scalars)
            else:
                jac = msm_pippenger(self.g1_lagrange_basis, scalars)
        with tracker.span("kzg.unpack"):
            return dc.unpack_points(tuple(t[None] for t in jac))[0]

    def collapsed_bases(self, upto: int | None = None) -> list:
        """collapsed_bases()[k]: the basis folded k+1 times -- the commitment
        basis of the step-k quotient (size 2^(n-1-k)). Built incrementally, one
        point addition of the two halves a fold."""
        if upto is None:
            upto = self.num_vars
        chain = self._collapsed if self._collapsed is not None else []
        while len(chain) < upto:
            prev = self.g1_lagrange_basis if not chain else chain[-1]
            half = prev[0].shape[0] // 2
            chain.append(dc.point_add(
                tuple(v[:half].contiguous() for v in prev),
                tuple(v[half:].contiguous() for v in prev),
            ))
        self._collapsed = chain
        return chain

    def open(self, opening_values: list[int], poly: MultilinearPoly) -> int:
        with tracker.span("kzg.open"):
            return poly.evaluate_int(list(opening_values))

    def _quotients(self, opened_value: int, opening_values: list[int],
                   poly: MultilinearPoly) -> list:
        """The n quotient tables of one opening, canonical words: quotient k has
        2^(n-1-k) entries."""
        self._check_poly(poly)
        if len(opening_values) != self.num_vars:
            raise ValueError("invalid number of opening values")
        ctx = poly.ctx
        with tracker.span("kzg.quotients"):
            table = fb.sub(ctx, poly.table, poly.encode_scalar(opened_value % FR.modulus))
            values = poly.encode_scalar([v % FR.modulus for v in opening_values])
            quotients = []
            for k in range(self.num_vars):
                half = table.shape[0] // 2
                quotient = fb.sub(ctx, table[half:], table[:half])  # f|x0=1 - f|x0=0
                quotients.append(fk.from_mont(ctx, quotient.contiguous()))
                # remainder: fold variable 0 at the opening value
                table = fk.fold(ctx, table, values[k])
        return quotients

    def _commit_quotients(self, *openings) -> list:
        """Commit the quotient lists of S openings: at step k the S quotients
        share ``collapsed_bases()[k]`` and ride one batched MSM; on one device
        the n steps' window combines run in one launch, and under an active
        mesh a step whose S segments of 2^(n-1-k) entries give its slots enough
        rows is segment-sharded. Returns S lists of n host points."""
        with tracker.span("kzg.quotient_msms"):
            bases = self.collapsed_bases()
            mesh = pctx.current_mesh()
            stacked = [torch.stack([q[k] for q in openings]) for k in range(self.num_vars)]
            if mesh is None:
                steps = msm_pippenger_multi_batches(list(zip(bases, stacked)))
            else:
                steps = [pm.msm_pippenger_multi_sharded(mesh, base, batch)
                         if pctx.shardable(batch.shape[0] * batch.shape[1], mesh)
                         else msm_pippenger_multi(base, batch)
                         for base, batch in zip(bases, stacked)]
        # (n, S, 12) -> host points, opening by opening
        with tracker.span("kzg.unpack"):
            flat = dc.unpack_points(
                tuple(torch.stack([s[i] for s in steps], dim=1).contiguous() for i in range(3))
            )
        n = self.num_vars
        return [flat[s * n: (s + 1) * n] for s in range(len(openings))]

    def get_proof(self, opened_value: int, opening_values: list[int],
                  poly: MultilinearPoly) -> list:
        """One quotient commitment per variable (reference :59-95)."""
        return self._commit_quotients(self._quotients(opened_value, opening_values, poly))[0]

    def get_proof_pair(self, openings_b, openings_c, poly: MultilinearPoly):
        """Both GKR opening proofs (r_b, r_c): two segments a step."""
        (val_b, pts_b), (val_c, pts_c) = openings_b, openings_c
        proofs = self._commit_quotients(
            self._quotients(val_b, pts_b, poly), self._quotients(val_c, pts_c, poly)
        )
        return proofs[0], proofs[1]

    def commit_with_proof_pair(self, openings_b, openings_c, poly: MultilinearPoly):
        """(commitment, proofs_b, proofs_c) of a GKR input proof."""
        commitment = self.commit(poly)
        proofs_b, proofs_c = self.get_proof_pair(openings_b, openings_c, poly)
        return commitment, proofs_b, proofs_c

    @staticmethod
    def verify(commitment, opened_value: int, proof: list, opening_values: list[int],
               g2_taus: list) -> bool:
        """Host pairing product check (reference :97-128), with a single final
        exponentiation."""
        if len(proof) != len(opening_values):
            raise ValueError(
                "num of quotients in proof not equal to num of opening values"
            )
        lhs_pt = hc.add(commitment, hc.neg(hc.multiply(hc.G1_GEN, opened_value)))
        lhs = [(lhs_pt, hc.G2_GEN)]
        rhs = []
        for i, a_i in enumerate(opening_values):
            factor = hc.add(g2_taus[i], hc.neg(hc.multiply(hc.G2_GEN, a_i)))
            rhs.append((proof[i], factor))
        return hc.pairing_product_equals(lhs, rhs)

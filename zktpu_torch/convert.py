"""State carried between the JAX package's layouts and this package's.

Functions on numpy arrays; nothing here imports JAX. Both packages hold the
same integers in the same Montgomery domain, so every map is an exact
reinterpretation:

  * a field element is ``N`` 16-bit digits, one per uint32 lane, in ``zktpu``,
    and ``N / 2`` little-endian 32-bit words (int32 bit pattern) here;
  * a lazy sum row is ``N + 2`` digits there and ``N / 2 + 1`` words here;
  * a Keccak lane is a (lo, hi) pair of uint32 there and one int64 here;
  * a batch of Jacobian points is a triple of ``(B, 24)`` digit arrays there (or
    limb-major ``(24, B)`` inside its MSMs) and a triple of ``(B, 12)`` word
    tensors here; a host point is a pair of that package's ``FQ`` there and of
    this package's own ``FQ`` here.

The tests use these so that both packages compute on the same table and are
compared word for word.
"""

from __future__ import annotations

import numpy as np
import torch

from .curve import bls12_381 as hc
from .gkr.protocol import GkrProof, KzgProof
from .hash.keccak_device import pairs_to_lanes
from .pcs.kzg import KZG
from .poly.multilinear import MultilinearPoly
from .poly.univariate import UnivariatePoly
from .sumcheck.protocol import GkrSumcheckProof, Proof


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


def round_polys_from_zktpu(spec, polys) -> list[UnivariatePoly]:
    """Round polynomials (any objects with ``coefficients``) -> this package's
    ``UnivariatePoly`` over ``spec``, coefficient for coefficient."""
    return [UnivariatePoly(spec, [int(c) for c in poly.coefficients]) for poly in polys]


def round_polys_to_zktpu(polys, cls, spec) -> list:
    """This package's round polynomials -> ``cls(spec, coefficients)``; the caller
    passes ``zktpu.poly.univariate.UnivariatePoly`` and zktpu's field spec."""
    return [cls(spec, [int(c) for c in poly.coefficients]) for poly in polys]


def gkr_sumcheck_proof_from_zktpu(spec, proof) -> GkrSumcheckProof:
    """``zktpu.sumcheck.protocol.GkrSumcheckProof`` -> this package's."""
    return GkrSumcheckProof(
        round_polys_from_zktpu(spec, proof.proof_polynomials),
        int(proof.claimed_sum),
        [int(r) for r in proof.random_challenges],
    )


def points_from_zktpu(jac, limb_major: bool = False) -> tuple:
    """A Jacobian triple of ``(B, 24)`` digit arrays (``limb_major``: ``(24, B)``)
    -> this package's triple of ``(B, 12)`` int32 word tensors (CPU)."""
    out = []
    for coord in jac:
        coord = np.asarray(coord)
        if limb_major:
            coord = np.swapaxes(coord, -1, -2)
        out.append(table_from_zktpu(coord))
    return tuple(out)


def points_to_zktpu(jac, limb_major: bool = False) -> tuple:
    """This package's ``(B, 12)`` word triple -> ``(B, 24)`` uint32 digit arrays
    (``limb_major``: ``(24, B)``)."""
    out = tuple(table_to_zktpu(coord) for coord in jac)
    if limb_major:
        out = tuple(np.ascontiguousarray(np.swapaxes(coord, -1, -2)) for coord in out)
    return out


def scalars_from_zktpu(digits) -> torch.Tensor:
    """Canonical ``(..., 16)`` Fr digit arrays -> ``(..., 8)`` word tensor (CPU)."""
    return table_from_zktpu(digits)


def scalars_to_zktpu(words) -> np.ndarray:
    return table_to_zktpu(words)


def host_point_from_zktpu(pt):
    """A host affine point of ``zktpu.curve.bls12_381`` (G1 or G2, ``None`` for
    infinity) -> the same point over this package's own field classes."""
    if pt is None:
        return None

    def coord(c):
        if hasattr(c, "coeffs"):
            return hc.FQ2([int(v) for v in c.coeffs])
        return hc.FQ(int(c.n))

    return (coord(pt[0]), coord(pt[1]))


def kzg_from_zktpu(kzg, device="cpu") -> KZG:
    """A ``zktpu.pcs.kzg.KZG`` (its basis as arrays, its ``g2_taus``) -> this
    package's, with the basis on ``device``."""
    basis = tuple(
        t.to(device) for t in points_from_zktpu([np.asarray(c) for c in kzg.g1_lagrange_basis])
    )
    return KZG(basis, [host_point_from_zktpu(pt) for pt in kzg.g2_taus], int(kzg.num_vars))


def kzg_proof_from_zktpu(input_proof, device="cpu") -> KzgProof:
    """A ``zktpu.gkr.protocol.KzgProof`` -> this package's: the setup, the
    commitment, both lists of quotient points, both opened evaluations."""
    return KzgProof(
        kzg_setup=kzg_from_zktpu(input_proof.kzg_setup, device),
        commitment=host_point_from_zktpu(input_proof.commitment),
        proof=[[host_point_from_zktpu(pt) for pt in side] for side in input_proof.proof],
        opened_evals=[int(v) for v in input_proof.opened_evals],
    )


def gkr_proof_from_zktpu(ctx, proof) -> GkrProof:
    """A ``zktpu.gkr.protocol.GkrProof`` (output table, every layer's round
    polynomials, the claimed evaluations, the KZG input proof) -> this
    package's ``GkrProof`` on ``ctx.device``."""
    table = table_from_zktpu(np.asarray(proof.output_poly.table)).to(ctx.device)
    return GkrProof(
        MultilinearPoly(ctx, table),
        [round_polys_from_zktpu(ctx.spec, layer) for layer in proof.proof_polynomials],
        [(int(o_1), int(o_2)) for o_1, o_2 in proof.claimed_evaluations],
        kzg_proof_from_zktpu(proof.input_proof, ctx.device),
    )

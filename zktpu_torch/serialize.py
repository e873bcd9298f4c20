"""Canonical byte serialization of proofs.

This package's own copy of the JAX package's ``serialize.py``: the same bytes
for the same proof. The encoders, the decoders and ``Reader`` are host code
over Python ints and host curve points, copied as they are.

* **Field elements**: little-endian canonical (non-Montgomery) bytes of
  ``spec.byte_len`` -- the arkworks ``into_bigint().to_bytes_le()`` layout that
  the Fiat-Shamir transcript uses too.
* **G1/G2 points**: arkworks-style compressed encoding -- the x coordinate
  (G2: c0 then c1) in little-endian bytes, with two flag bits in the MOST
  significant byte: 0x80 = y is the lexicographically larger root,
  0x40 = point at infinity (x forced to 0).
* **Containers**: little-endian u32 length prefixes; one format-version byte
  leads every top-level proof blob.

Every encoder has a matching decoder and the round trip is exact. Two things
differ from the JAX package: ``decode_gkr_proof(data, device=None)`` builds the
output polynomial on ``device`` (``None``: the card, and it raises where there
is none), and a decoded ``KzgProof`` carries a ``KZG`` without its G1 Lagrange
basis, which ``gkr.protocol.verify`` does not read. Malformed bytes raise
``ValueError``.
"""

from __future__ import annotations

import struct

from .field.spec import BLS12_381_FR, FieldSpec
from .curve import bls12_381 as hc

VERSION = 1


def _fq_modulus() -> int:
    from .field.spec import BLS12_381_FQ

    return BLS12_381_FQ.modulus


G1_BYTES = 48
G2_BYTES = 96
_INF_FLAG = 0x40
_SIGN_FLAG = 0x80


# ----------------------------------------------------------------------
# primitives
# ----------------------------------------------------------------------

def _u32(value: int) -> bytes:
    return struct.pack("<I", value)


class Reader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated proof bytes")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def done(self) -> bool:
        return self.pos == len(self.data)


def encode_field(value: int, spec: FieldSpec = BLS12_381_FR) -> bytes:
    return spec.to_bytes_le(value)


def decode_field(r: Reader, spec: FieldSpec = BLS12_381_FR) -> int:
    v = int.from_bytes(r.take(spec.byte_len), "little")
    if v >= spec.modulus:
        raise ValueError("non-canonical field element")
    return v


def _encode_fields(values, spec: FieldSpec = BLS12_381_FR) -> bytes:
    return _u32(len(values)) + b"".join(encode_field(int(v), spec) for v in values)


def _decode_fields(r: Reader, spec: FieldSpec = BLS12_381_FR) -> list[int]:
    return [decode_field(r, spec) for _ in range(r.u32())]


def encode_g1(pt) -> bytes:
    """Affine host point ((FQ, FQ) or None) -> 48-byte compressed blob."""
    p = _fq_modulus()
    if pt is None:
        data = bytearray(G1_BYTES)
        data[-1] |= _INF_FLAG
        return bytes(data)
    x, y = int(pt[0].n), int(pt[1].n)
    data = bytearray(x.to_bytes(G1_BYTES, "little"))
    if y > (p - 1) // 2:
        data[-1] |= _SIGN_FLAG
    return bytes(data)


def decode_g1(r: Reader):
    p = _fq_modulus()
    data = bytearray(r.take(G1_BYTES))
    flags = data[-1] & 0xC0
    data[-1] &= 0x3F
    if flags & _INF_FLAG:
        if any(data):
            raise ValueError("non-zero infinity encoding")
        return None
    x = int.from_bytes(bytes(data), "little")
    if x >= p:
        raise ValueError("non-canonical G1 x")
    # y^2 = x^3 + 4; p == 3 mod 4 so sqrt = v^((p+1)/4)
    rhs = (pow(x, 3, p) + 4) % p
    y = pow(rhs, (p + 1) // 4, p)
    if y * y % p != rhs:
        raise ValueError("x not on curve")
    if (y > (p - 1) // 2) != bool(flags & _SIGN_FLAG):
        y = (p - y) % p
    return (hc.FQ(x), hc.FQ(y))


def encode_g2(pt) -> bytes:
    """Affine host G2 point ((FQ2, FQ2) or None) -> 96-byte compressed blob.
    x = c0 + c1*u serialized c0 || c1; sign flag = lexicographic order on
    (c1, c0) of y."""
    p = _fq_modulus()
    if pt is None:
        data = bytearray(G2_BYTES)
        data[-1] |= _INF_FLAG
        return bytes(data)
    x, y = pt
    data = bytearray(
        int(x.coeffs[0]).to_bytes(G1_BYTES, "little")
        + int(x.coeffs[1]).to_bytes(G1_BYTES, "little")
    )
    y_key = (int(y.coeffs[1]), int(y.coeffs[0]))
    neg_y = ((-y.coeffs[1]) % p, (-y.coeffs[0]) % p)
    if y_key > neg_y:
        data[-1] |= _SIGN_FLAG
    return bytes(data)


def decode_g2(r: Reader):
    p = _fq_modulus()
    data = bytearray(r.take(G2_BYTES))
    flags = data[-1] & 0xC0
    data[-1] &= 0x3F
    if flags & _INF_FLAG:
        if any(data):
            raise ValueError("non-zero infinity encoding")
        return None
    c0 = int.from_bytes(bytes(data[:G1_BYTES]), "little")
    c1 = int.from_bytes(bytes(data[G1_BYTES:]), "little")
    if c0 >= p or c1 >= p:
        raise ValueError("non-canonical G2 x")
    x = hc.FQ2([c0, c1])
    rhs = x * x * x + hc.B2
    y = _fq2_sqrt(rhs)
    if y is None:
        raise ValueError("x not on G2 curve")
    y_key = (int(y.coeffs[1]), int(y.coeffs[0]))
    neg_key = ((-y.coeffs[1]) % p, (-y.coeffs[0]) % p)
    if (y_key > neg_key) != bool(flags & _SIGN_FLAG):
        y = hc.FQ2([(-y.coeffs[0]) % p, (-y.coeffs[1]) % p])
    return (x, y)


def _fq2_sqrt(a):
    """Square root in Fq2 (p == 3 mod 4): candidate a^((p^2+7)/16)-free
    algorithm -- use the complex method: sqrt(a) via norm."""
    p = _fq_modulus()
    a0, a1 = int(a.coeffs[0]), int(a.coeffs[1])
    if a1 == 0:
        # sqrt in Fq or sqrt of non-residue times u
        y0 = pow(a0, (p + 1) // 4, p)
        if y0 * y0 % p == a0:
            return hc.FQ2([y0, 0])
        # a0 is a non-residue: sqrt = u * sqrt(-a0) since u^2 = -1
        y1 = pow((-a0) % p, (p + 1) // 4, p)
        if y1 * y1 % p == (-a0) % p:
            return hc.FQ2([0, y1])
        return None
    # norm = a0^2 + a1^2 must be a QR in Fq
    norm = (a0 * a0 + a1 * a1) % p
    n_sqrt = pow(norm, (p + 1) // 4, p)
    if n_sqrt * n_sqrt % p != norm:
        return None
    for sign in (1, p - 1):
        alpha = (a0 + sign * n_sqrt) % p * pow(2, -1, p) % p
        x0 = pow(alpha, (p + 1) // 4, p)
        if x0 * x0 % p != alpha or x0 == 0:
            continue
        x1 = a1 * pow(2 * x0, -1, p) % p
        cand = hc.FQ2([x0, x1])
        if (cand * cand).coeffs == a.coeffs:
            return cand
    return None


def _encode_g1_list(points) -> bytes:
    return _u32(len(points)) + b"".join(encode_g1(pt) for pt in points)


def _decode_g1_list(r: Reader) -> list:
    return [decode_g1(r) for _ in range(r.u32())]


def _encode_poly(poly) -> bytes:
    """UnivariatePoly -> u32 len + coefficient bytes."""
    return _encode_fields(poly.coefficients)


def _decode_poly(r: Reader):
    from .poly.univariate import UnivariatePoly

    return UnivariatePoly(BLS12_381_FR, _decode_fields(r))


# ----------------------------------------------------------------------
# proof containers
# ----------------------------------------------------------------------

def encode_sumcheck_proof(proof, spec: FieldSpec) -> bytes:
    """Plain-sumcheck ``Proof`` (``sumcheck/protocol.py``) -> bytes."""
    out = [bytes([VERSION]), encode_field(proof.claimed_sum, spec),
           _u32(len(proof.proof_polynomials))]
    for halves in proof.proof_polynomials:
        out.append(_encode_fields(halves, spec))
    return b"".join(out)


def decode_sumcheck_proof(data: bytes, spec: FieldSpec):
    from .sumcheck.protocol import Proof

    r = Reader(data)
    if r.take(1)[0] != VERSION:
        raise ValueError("unknown proof version")
    claimed = decode_field(r, spec)
    polys = [_decode_fields(r, spec) for _ in range(r.u32())]
    if not r.done():
        raise ValueError("trailing bytes")
    return Proof(polys, claimed)


def encode_gkr_sumcheck_proof(proof) -> bytes:
    """``GkrSumcheckProof`` -> bytes (BLS12-381 Fr)."""
    out = [bytes([VERSION]), encode_field(proof.claimed_sum),
           _u32(len(proof.proof_polynomials))]
    for poly in proof.proof_polynomials:
        out.append(_encode_poly(poly))
    out.append(_encode_fields(proof.random_challenges))
    return b"".join(out)


def decode_gkr_sumcheck_proof(data: bytes):
    from .sumcheck.protocol import GkrSumcheckProof

    r = Reader(data)
    if r.take(1)[0] != VERSION:
        raise ValueError("unknown proof version")
    claimed = decode_field(r)
    polys = [_decode_poly(r) for _ in range(r.u32())]
    challenges = _decode_fields(r)
    if not r.done():
        raise ValueError("trailing bytes")
    return GkrSumcheckProof(polys, claimed, challenges)


def encode_kzg_proof(proof) -> bytes:
    """GKR ``KzgProof``: commitment + 2 quotient lists + opened evals +
    the verifier-side setup (g2_taus). The G1 Lagrange basis is prover-side
    state and deliberately NOT part of the proof."""
    out = [bytes([VERSION]), encode_g1(proof.commitment)]
    out.append(_u32(len(proof.proof)))
    for quotients in proof.proof:
        out.append(_encode_g1_list(quotients))
    out.append(_encode_fields(proof.opened_evals))
    g2 = proof.kzg_setup.g2_taus
    out.append(_u32(len(g2)))
    for pt in g2:
        out.append(encode_g2(pt))
    return b"".join(out)


def decode_kzg_proof(data_or_reader):
    from .gkr.protocol import KzgProof
    from .pcs.kzg import KZG

    r = data_or_reader if isinstance(data_or_reader, Reader) else Reader(data_or_reader)
    if r.take(1)[0] != VERSION:
        raise ValueError("unknown proof version")
    commitment = decode_g1(r)
    proof = [_decode_g1_list(r) for _ in range(r.u32())]
    opened = _decode_fields(r)
    g2_taus = [decode_g2(r) for _ in range(r.u32())]
    setup = KZG(g1_lagrange_basis=None, g2_taus=g2_taus, num_vars=len(g2_taus))
    return KzgProof(kzg_setup=setup, commitment=commitment, proof=proof,
                    opened_evals=opened)


def encode_gkr_proof(proof) -> bytes:
    """Full ``GkrProof`` -> canonical bytes."""
    out = [bytes([VERSION])]
    out.append(_encode_fields(proof.output_poly.to_ints()))
    out.append(_u32(len(proof.proof_polynomials)))
    for layer_polys in proof.proof_polynomials:
        out.append(_u32(len(layer_polys)))
        for poly in layer_polys:
            out.append(_encode_poly(poly))
    out.append(_u32(len(proof.claimed_evaluations)))
    for o1, o2 in proof.claimed_evaluations:
        out.append(encode_field(o1) + encode_field(o2))
    out.append(encode_kzg_proof(proof.input_proof))
    return b"".join(out)


def decode_gkr_proof(data: bytes, device=None):
    """Bytes -> ``GkrProof`` with its output polynomial on ``device`` (``None``:
    the card; it raises where there is none)."""
    from .field import torch_backend as fb
    from .gkr.protocol import GkrProof
    from .poly.multilinear import MultilinearPoly

    ctx = fb.get_ctx(BLS12_381_FR, device)
    r = Reader(data)
    if r.take(1)[0] != VERSION:
        raise ValueError("unknown proof version")
    outputs = _decode_fields(r)
    if not outputs or len(outputs) & (len(outputs) - 1):
        raise ValueError("output table length is not a power of two")
    output_poly = MultilinearPoly.from_ints(ctx, outputs)
    layer_polys = []
    for _ in range(r.u32()):
        layer_polys.append([_decode_poly(r) for _ in range(r.u32())])
    claimed = []
    for _ in range(r.u32()):
        claimed.append((decode_field(r), decode_field(r)))
    input_proof = decode_kzg_proof(r)
    if not r.done():
        raise ValueError("trailing bytes")
    return GkrProof(output_poly, layer_polys, claimed, input_proof)

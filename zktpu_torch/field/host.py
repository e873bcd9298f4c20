"""Host-side exact field arithmetic over Python integers.

This is the control-path / oracle layer: protocol logic that touches only a
handful of field elements (round-poly interpolation, verifier algebra, test
vectors) runs here with arbitrary-precision integers, while every O(2^n) data
path runs on device (``zktpu_torch.field.torch_backend``).

It mirrors the semantics of arkworks ``PrimeField`` as used by the reference
(univariate_polynomial/src/univariate_polynomial_dense.rs of the reference and
friends); all values are canonical representatives in ``[0, p)``.
"""

from __future__ import annotations

from .spec import FieldSpec


def add(spec: FieldSpec, a: int, b: int) -> int:
    return (a + b) % spec.modulus


def sub(spec: FieldSpec, a: int, b: int) -> int:
    return (a - b) % spec.modulus


def mul(spec: FieldSpec, a: int, b: int) -> int:
    return (a * b) % spec.modulus


def neg(spec: FieldSpec, a: int) -> int:
    return (-a) % spec.modulus


def inv(spec: FieldSpec, a: int) -> int:
    if a % spec.modulus == 0:
        raise ZeroDivisionError("inverse of zero field element")
    return pow(a, -1, spec.modulus)


def div(spec: FieldSpec, a: int, b: int) -> int:
    return a * inv(spec, b) % spec.modulus


def pow_(spec: FieldSpec, a: int, e: int) -> int:
    return pow(a, e, spec.modulus)


def batch_inv(spec: FieldSpec, values: list[int]) -> list[int]:
    """Montgomery batch inversion; one modular inverse for the whole list."""
    p = spec.modulus
    prefix = []
    acc = 1
    for v in values:
        prefix.append(acc)
        acc = acc * v % p
    acc_inv = inv(spec, acc)
    out = [0] * len(values)
    for i in range(len(values) - 1, -1, -1):
        out[i] = acc_inv * prefix[i] % p
        acc_inv = acc_inv * values[i] % p
    return out


def vec_to_bytes(spec: FieldSpec, values) -> bytes:
    """Exact replica of ``fq_vec_to_bytes``
    (fiat_shamir/src/fiat_shamir_transcript.rs:32-37 of the reference):
    concatenated little-endian canonical bigint bytes of each element."""
    return b"".join(spec.to_bytes_le(v) for v in values)

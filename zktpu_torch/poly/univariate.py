"""Dense univariate polynomials (host control-path).

Capability parity with the reference's univariate_polynomial/src/
univariate_polynomial_dense.rs: ``evaluate`` (:20-26), ``degree``+``trim``
(:14-18,28-32), ``scalar_mul`` (:34-46), Lagrange ``interpolate`` (:48-74),
``Add`` (:77-93), schoolbook ``Mul`` (:95-109).

Design note: in the protocols these polynomials are tiny (round polys of
degree <= #product-factors, interpolation through <= 8 points), so they live
on host with exact Python-int arithmetic -- the same split the reference makes
(scalar control flow around a bigint kernel layer). The trailing-zero ``trim``
semantics are replicated exactly because the *coefficient vector* is what the
Fiat-Shamir transcript absorbs (the reference's sum_check/src/
sum_check_protocol.rs:99).

Batched device evaluation of many points is the NTT's job (a later part of this
package) and ``zktpu_torch.poly.multilinear``'s (MLE folds).
"""

from __future__ import annotations

from ..field import host
from ..field.spec import FieldSpec


class UnivariatePoly:
    __slots__ = ("spec", "coefficients")

    def __init__(self, spec: FieldSpec, coefficients):
        self.spec = spec
        self.coefficients = [c % spec.modulus for c in coefficients]

    def __repr__(self):
        return f"UnivariatePoly({self.spec.name}, {self.coefficients})"

    def __eq__(self, other):
        return (
            isinstance(other, UnivariatePoly)
            and self.spec is other.spec
            and self.coefficients == other.coefficients
        )

    def trim(self) -> None:
        """Drop trailing zero coefficients (reference ``trim``, :14-18)."""
        while self.coefficients and self.coefficients[-1] == 0:
            self.coefficients.pop()

    def degree(self) -> int:
        self.trim()
        return len(self.coefficients) - 1

    def evaluate(self, x: int) -> int:
        """Horner evaluation; equals the reference's sum of c_i * x^i."""
        acc = 0
        for c in reversed(self.coefficients):
            acc = (acc * x + c) % self.spec.modulus
        return acc

    def scalar_mul(self, scalar: int) -> "UnivariatePoly":
        out = UnivariatePoly(
            self.spec, [c * scalar % self.spec.modulus for c in self.coefficients]
        )
        out.trim()
        return out

    def __add__(self, other: "UnivariatePoly") -> "UnivariatePoly":
        n = max(len(self.coefficients), len(other.coefficients))
        out = [0] * n
        for i, c in enumerate(self.coefficients):
            out[i] = c
        for i, c in enumerate(other.coefficients):
            out[i] = (out[i] + c) % self.spec.modulus
        return UnivariatePoly(self.spec, out)

    def __mul__(self, other: "UnivariatePoly") -> "UnivariatePoly":
        a, b = self.coefficients, other.coefficients
        if not a or not b:
            return UnivariatePoly(self.spec, [])
        out = [0] * (len(a) + len(b) - 1)
        p = self.spec.modulus
        for i, x in enumerate(a):
            for j, y in enumerate(b):
                out[i + j] = (out[i + j] + x * y) % p
        return UnivariatePoly(self.spec, out)

    @classmethod
    def interpolate(cls, spec: FieldSpec, points) -> "UnivariatePoly":
        """Lagrange interpolation through ``points = [(x, y), ...]``.

        Uses a single batch inversion for the denominators instead of the
        reference's per-pair division (kzg-style output is identical)."""
        pts = [(x % spec.modulus, y % spec.modulus) for x, y in points]
        n = len(pts)
        denoms = []
        for i in range(n):
            d = 1
            for j in range(n):
                if i != j:
                    d = d * (pts[i][0] - pts[j][0]) % spec.modulus
            denoms.append(d)
        inv_denoms = host.batch_inv(spec, denoms)

        result = cls(spec, [0])
        for i in range(n):
            x_i, y_i = pts[i]
            l_i = cls(spec, [1])
            for j in range(n):
                if i != j:
                    x_j = pts[j][0]
                    l_i = l_i * cls(spec, [-x_j, 1])
            result = result + l_i.scalar_mul(y_i * inv_denoms[i] % spec.modulus)
        result.trim()
        return result

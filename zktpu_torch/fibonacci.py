"""Fibonacci interpolation demo.

Capability parity with the reference's sample_tests/src/
fibonacci_evaluation.rs:10-34 (and the binary entry main.rs:5-9): interpolate
a degree-7 polynomial through the first 8 Fibonacci numbers and check
p(x) = p(x-1) + p(x-2) at sample points.
"""

from __future__ import annotations

from .field.spec import BN254_FQ
from .poly.univariate import UnivariatePoly

FIB_POINTS = [1, 1, 2, 3, 5, 8, 13, 21]


def fibonacci_check() -> bool:
    spec = BN254_FQ
    poly = UnivariatePoly.interpolate(spec, list(enumerate(FIB_POINTS)))
    for x in (2, 5, 7):
        lhs = poly.evaluate(x)
        rhs = (poly.evaluate(x - 1) + poly.evaluate(x - 2)) % spec.modulus
        if lhs != rhs:
            return False
    return True


def main() -> None:
    print("ZK Bootcamp")
    assert fibonacci_check()
    print("fibonacci evaluation check passed")


if __name__ == "__main__":
    main()

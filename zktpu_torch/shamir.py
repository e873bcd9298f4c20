"""Shamir secret sharing over BN254 Fq.

Capability parity with the reference's shamir_secret_sharing/src/
shamir_secret_sharing.rs: interpolate a degree-(threshold-1) polynomial
through the secret point plus random points (:6-24), evaluate shares at
random x (:46-68), recover by re-interpolation (:26-38), read the secret at
the secret x (:40-44).

Reference quirk preserved: ``recover_polynomial`` uses ``points[0..4]``
whenever more than 3 points are supplied, ignoring the threshold (:31-35).

A ``seed`` parameter replaces ``StdRng::from_entropy`` so tests are
deterministic; omitted it draws from OS entropy.
"""

from __future__ import annotations

import random
import secrets

from .field.spec import BN254_FQ, FieldSpec
from .poly.univariate import UnivariatePoly

DEFAULT_SPEC = BN254_FQ


def _rng(seed):
    return random.Random(seed) if seed is not None else secrets.SystemRandom()


def create_polynomial(
    threshold: int, secret_value: int, secret_point: int,
    spec: FieldSpec = DEFAULT_SPEC, seed=None,
) -> UnivariatePoly:
    rng = _rng(seed)
    points = [(secret_point, secret_value)]
    for _ in range(1, threshold):
        points.append((rng.randrange(spec.modulus), rng.randrange(spec.modulus)))
    return UnivariatePoly.interpolate(spec, points)


def share_points(
    num_of_shares: int, threshold: int, poly: UnivariatePoly, seed=None
) -> list[tuple[int, int]]:
    if num_of_shares < threshold:
        raise ValueError("Num of shares too low")
    rng = _rng(seed)
    shares = []
    for _ in range(num_of_shares):
        x = rng.randrange(poly.spec.modulus)
        shares.append((x, poly.evaluate(x)))
    return shares


def recover_polynomial(
    points: list[tuple[int, int]], threshold: int, spec: FieldSpec = DEFAULT_SPEC
) -> UnivariatePoly:
    if len(points) < threshold:
        raise ValueError("Not enough points to recreate polynomial")
    selected = points[0:4] if len(points) > 3 else list(points)
    return UnivariatePoly.interpolate(spec, selected)


def get_secret(poly: UnivariatePoly, x_point: int) -> int:
    return poly.evaluate(x_point)

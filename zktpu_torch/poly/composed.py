"""Composed sum-of-products polynomials.

The counterpart of ``zktpu/poly/composed.py`` (capability parity with the
reference's multilinear_polynomial/src/composed_polynomial.rs): ``ProductPoly``
(same-size MLEs multiplied pointwise) and ``SumPoly`` (same-degree ProductPolys
summed).

Reference quirks preserved on purpose (they are part of the observable
protocol semantics):
  * ``reduce`` is hardcoded to exactly two factors / two product terms
    (:52-54, :88-99) -- the GKR f(b,c) polynomial always has that shape.
  * ``get_degree`` is the number of factors (:56-58).

The per-round hot path (evaluate the composed poly at t = 0..degree and sum)
is ``zktpu_torch.sumcheck.protocol.gkr_prove``; this module provides the
faithful building blocks.
"""

from __future__ import annotations

from ..field import kernels as fk
from ..field import torch_backend as fb
from .multilinear import MultilinearPoly, elementwise_op


class ProductPoly:
    __slots__ = ("ctx", "factors")

    def __init__(self, ctx, factors: list[MultilinearPoly]):
        if not factors:
            raise ValueError("empty product poly")
        size = factors[0].table.shape[0]
        if any(f.table.shape[0] != size for f in factors):
            raise ValueError("all evaluations must have same length")
        self.ctx = ctx
        self.factors = list(factors)

    @classmethod
    def from_ints(cls, ctx, evaluations: list[list[int]]) -> "ProductPoly":
        return cls(ctx, [MultilinearPoly.from_ints(ctx, e) for e in evaluations])

    @property
    def num_vars(self) -> int:
        return self.factors[0].num_vars

    def get_degree(self) -> int:
        return len(self.factors)

    def evaluate_mont(self, values_mont):
        acc = None
        for f in self.factors:
            v = f.evaluate_mont(values_mont)
            acc = v if acc is None else fk.mont_mul(self.ctx, acc, v)
        return acc

    def partial_evaluate(self, value_mont) -> "ProductPoly":
        """Fix variable 0 of every factor (reference :38-50)."""
        return ProductPoly(
            self.ctx, [f.partial_evaluate(0, value_mont) for f in self.factors]
        )

    def reduce_table(self):
        """Pointwise product of the first two factors (reference :52-54)."""
        return elementwise_op(
            self.ctx, self.factors[0].table, self.factors[1].table, "mul"
        )


class SumPoly:
    __slots__ = ("ctx", "products")

    def __init__(self, ctx, products: list[ProductPoly]):
        if not products:
            raise ValueError("empty sum poly")
        degree = products[0].get_degree()
        if any(p.get_degree() != degree for p in products):
            raise ValueError("all product polys must have same degree")
        self.ctx = ctx
        self.products = list(products)

    @property
    def num_vars(self) -> int:
        return self.products[0].num_vars

    def get_degree(self) -> int:
        return self.products[0].get_degree()

    def evaluate_mont(self, values_mont):
        acc = None
        for p in self.products:
            v = p.evaluate_mont(values_mont)
            acc = v if acc is None else fb.add(self.ctx, acc, v)
        return acc

    def evaluate_int(self, values_int, encode) -> int:
        vals = [encode(v) for v in values_int]
        out = fk.from_mont(self.ctx, self.evaluate_mont(vals))
        return int(self.ctx.unpack(out))

    def partial_evaluate(self, value_mont) -> "SumPoly":
        return SumPoly(self.ctx, [p.partial_evaluate(value_mont) for p in self.products])

    def reduce_table(self):
        """Pointwise sum of the first two products' reduces (reference :88-99)."""
        return elementwise_op(
            self.ctx, self.products[0].reduce_table(), self.products[1].reduce_table(), "add"
        )

"""Multilinear polynomials (MLEs) as device evaluation tables.

The counterpart of ``zktpu/poly/multilinear.py`` (capability parity with the
reference's multilinear_polynomial_evaluation.rs). The table over the boolean
hypercube is an int32 word tensor of shape ``(2^n, W)`` in Montgomery form, on
the device of its field context.

Variable-order contract: variable ``bit`` is counted from the MOST significant
index bit. On a tensor that means variable ``bit`` is axis ``bit`` of the table
viewed as an n-dimensional (2,)*n array, so ``partial_evaluate`` is a fold of
variable 0 over a stack of ``2^bit`` tables:

    table.reshape(2^bit, 2 * 2^(n-bit-1), W) -> a + v*(b - a)

which is exactly what the ``fold`` kernel takes with a leading dimension.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import kernels as fk
from ..field import torch_backend as fb
from ..field.torch_backend import FieldCtx
from ..hash.keccak import Sponge
from ..utils import tracker


def fold_bit(ctx: FieldCtx, table, bit: int, value):
    """partial_evaluate: fix variable ``bit`` (MSB-first) to ``value``."""
    n_entries = table.shape[0]
    stacked = table.reshape(1 << bit, n_entries >> bit, ctx.num_words)
    return fk.fold(ctx, stacked, value).reshape(n_entries // 2, ctx.num_words)


def tensor_op(ctx: FieldCtx, a, b, op: str):
    """tensor_add_mul_polynomials: out[i*|B| + j] = op(a_i, b_j)."""
    a2 = a[:, None, :]
    b2 = b[None, :, :]
    if op == "add":
        out = fb.add(ctx, a2, b2)
    elif op == "mul":
        out = fb.mont_mul(ctx, a2, b2)
    else:
        raise ValueError(op)
    return out.reshape(a.shape[0] * b.shape[0], ctx.num_words)


def elementwise_op(ctx: FieldCtx, a, b, op: str):
    if op == "add":
        return fb.add(ctx, a, b)
    if op == "sub":
        return fb.sub(ctx, a, b)
    if op == "mul":
        return fk.mont_mul(ctx, a, b)
    raise ValueError(op)


def evaluate_all(ctx: FieldCtx, table, values_mont):
    """Full evaluation at a point: num_vars folds of variable 0 (the verifier's
    final oracle check). ``values_mont``: (num_vars, W) Montgomery words."""
    for k in range(values_mont.shape[0]):
        table = fk.fold(ctx, table, values_mont[k])
    return table[0]


def halves_sum(ctx: FieldCtx, table):
    """[sum of first half, sum of second half], reduced mod p -- the
    plain-sumcheck round polynomial."""
    half = table.shape[0] // 2
    return torch.stack(
        [fb.field_sum(ctx, table[:half], axis=0), fb.field_sum(ctx, table[half:], axis=0)]
    )


class MultilinearPoly:
    """Evaluation-table MLE. ``table``: int32 (2^n, W), Montgomery domain, on
    ``ctx.device``."""

    __slots__ = ("ctx", "table", "num_vars", "_canonical_cache", "_bytes_cache",
                 "_sponge_cache")

    def __init__(self, ctx: FieldCtx, table, num_vars: int | None = None):
        if table.device != ctx.device:
            raise ValueError(f"table on {table.device}, context on {ctx.device}")
        self.ctx = ctx
        self.table = table
        self._canonical_cache = None
        self._bytes_cache = None
        self._sponge_cache = None
        n_entries = table.shape[0]
        nv = n_entries.bit_length() - 1
        if (1 << nv) != n_entries:
            raise ValueError("Invalid evaluations: length must be a power of two")
        self.num_vars = nv
        if num_vars is not None and num_vars != nv:
            raise ValueError("num_vars mismatch")

    # -- constructors / host IO -------------------------------------------

    @classmethod
    def from_ints(cls, ctx: FieldCtx, values) -> "MultilinearPoly":
        canonical = ctx.pack(list(values))
        poly = cls(ctx, fk.to_mont(ctx, ctx.to_device(canonical)))
        # host-constructed tables keep their canonical words so transcript
        # absorption never pulls the table back across the device boundary
        poly._canonical_cache = canonical
        return poly

    def to_ints(self) -> list[int]:
        return [int(v) for v in self.ctx.unpack(self.canonical_table())]

    def canonical_table(self) -> np.ndarray:
        """Canonical (non-Montgomery) words on the host, for serialization."""
        if self._canonical_cache is not None:
            return self._canonical_cache
        return fb.tensor_to_words(fk.from_mont(self.ctx, self.table))

    def to_transcript_bytes(self) -> bytes:
        if self._bytes_cache is None:
            self._bytes_cache = self.ctx.canonical_to_bytes(self.canonical_table())
        return self._bytes_cache

    def transcript_sponge(self) -> Sponge:
        """Keccak sponge pre-absorbed with this table's transcript bytes
        (cached: prover and verifier share one pass over the table)."""
        if self._sponge_cache is None:
            sp = Sponge()
            sp.absorb(self.to_transcript_bytes())
            self._sponge_cache = sp
        return self._sponge_cache.copy()

    # -- core ops ----------------------------------------------------------

    def partial_evaluate(self, bit: int, value_mont) -> "MultilinearPoly":
        if self.num_vars == 0:
            raise ValueError("cannot fold a constant")
        half = self.table.shape[0] // 2
        tracker.count("mul", half)
        tracker.count("add", half)
        tracker.count("sub", half)
        return MultilinearPoly(self.ctx, fold_bit(self.ctx, self.table, bit, value_mont))

    def multi_partial_evaluate(self, values_mont) -> "MultilinearPoly":
        """Fold variable 0 repeatedly."""
        poly = self
        for v in values_mont:
            poly = poly.partial_evaluate(0, v)
        return poly

    def evaluate_mont(self, values_mont):
        """Full evaluation at a point; returns (W,) Montgomery words."""
        if len(values_mont) != self.num_vars:
            raise ValueError("Invalid number of values")
        if self.num_vars == 0:
            return self.table[0]
        tracker.count("mul", self.table.shape[0] - 1)
        tracker.count("add", 2 * (self.table.shape[0] - 1))
        return evaluate_all(self.ctx, self.table, torch.stack(list(values_mont)))

    def evaluate_int(self, values_int: list[int]) -> int:
        vals = self.encode_scalar(list(values_int)) if values_int else []
        out = fk.from_mont(self.ctx, self.evaluate_mont(vals))
        return int(self.ctx.unpack(out))

    def scale(self, value_mont) -> "MultilinearPoly":
        tracker.count("mul", self.table.shape[0])
        return MultilinearPoly(self.ctx, fk.mont_mul(self.ctx, self.table, value_mont))

    def sum_mont(self):
        tracker.count("add", max(0, self.table.shape[0] - 1))
        return fb.field_sum(self.ctx, self.table, axis=0)

    def halves_sums(self):
        return halves_sum(self.ctx, self.table)

    def encode_scalar(self, value):
        """Host int (or list of ints) -> (W,) (or (k, W)) Montgomery words on
        the device."""
        return fk.to_mont(self.ctx, self.ctx.to_device(self.ctx.pack(value)))

    # -- elementwise algebra ----------------------------------------------

    def _binop(self, other, op):
        if other.table.shape != self.table.shape:
            raise ValueError("shape mismatch")
        tracker.count("mul" if op == "mul" else "add", self.table.shape[0])
        return MultilinearPoly(
            self.ctx, elementwise_op(self.ctx, self.table, other.table, op)
        )

    def __add__(self, other):
        return self._binop(other, "add")

    def __sub__(self, other):
        return self._binop(other, "sub")

    def __mul__(self, other):
        return self._binop(other, "mul")

    @classmethod
    def tensor_add_mul(cls, ctx, a: "MultilinearPoly", b: "MultilinearPoly", op: str):
        """(b,c)-tensor table op(a_i, b_j) of size |A|*|B|."""
        tracker.count("mul" if op == "mul" else "add",
                      a.table.shape[0] * b.table.shape[0])
        return cls(ctx, tensor_op(ctx, a.table, b.table, op))

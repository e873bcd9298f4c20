"""Layered arithmetic circuits of fan-in-2 add/mul gates.

The counterpart of ``zktpu/gkr/circuit.py`` (capability parity with the
reference's gkr/src/gkr_circuit.rs):
  * ``Circuit``/``Layer`` built from a structure of per-layer operations
    (:113-125); ``layers[0]`` is adjacent to the inputs, the last layer is the
    single output gate.
  * ``evaluate`` runs layer by layer, each gate consuming consecutive pairs
    of the previous values, and returns EVERY layer's outputs (:127-143) --
    the prover needs all of them.
  * ``get_add_mul_i`` builds the wiring-predicate MLE add_i/mul_i(a,b,c) as a
    one-hot table (:39-52) with the reference's exact (idiosyncratic) bit
    packing (:54-104): gate index a gets log2(n) bits, inputs b=2a and c=2a+1
    get log2(n)+1 bits each, all concatenated MSB-first; a single-gate layer
    uses 3 one-bit segments.

Layer evaluation is one pass per layer: view the input table as (gates, 2),
compute both the sum and the product of each pair, and select by a per-gate
mask. The product goes through the ``mont_mul`` kernel; the sum and the select
are plain tensor operations.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import kernels as fk
from ..field import torch_backend as fb
from ..field.torch_backend import FieldCtx
from ..poly.multilinear import MultilinearPoly

ADD = "add"
MUL = "mul"


def layer_eval_kernel(ctx: FieldCtx, table, is_add_mask):
    """One circuit layer: out[g] = op_g(in[2g], in[2g+1])."""
    n_gates = table.shape[0] // 2
    shaped = table.reshape(n_gates, 2, ctx.num_words)
    left = shaped[:, 0].contiguous()
    right = shaped[:, 1].contiguous()
    added = fb.add(ctx, left, right)
    mulled = fk.mont_mul(ctx, left, right)
    return torch.where(is_add_mask[:, None], added, mulled)


class Layer:
    __slots__ = ("ops", "_add_masks")

    def __init__(self, ops: list[str]):
        if not ops:
            raise ValueError("There must be at least one gate in the layer.")
        if any(op not in (ADD, MUL) for op in ops):
            raise ValueError("ops must be 'add' or 'mul'")
        self.ops = list(ops)
        self._add_masks: dict[torch.device, torch.Tensor] = {}

    @property
    def n_gates(self) -> int:
        return len(self.ops)

    def bits_for_gates(self) -> int:
        """Reference ``get_bits_for_gates`` (:54-65)."""
        n = self.n_gates
        if n == 1:
            return 3
        log_n = n.bit_length() - 1  # floor(log2), matches Rust ilog2
        return log_n + 2 * (log_n + 1)

    def gate_positions(self) -> np.ndarray:
        """One-hot index of each gate in the wiring MLE (reference
        ``gate_to_bits``, :67-104): MSB-first concat of (a | b=2a | c=2a+1)."""
        n = self.n_gates
        if n == 1:
            widths = (1, 1, 1)
        else:
            log_n = n.bit_length() - 1
            widths = (log_n, log_n + 1, log_n + 1)
        out = np.empty(n, dtype=np.int64)
        for idx in range(n):
            acc = 0
            for value, width in zip((idx, 2 * idx, 2 * idx + 1), widths):
                acc = (acc << width) | value
            out[idx] = acc
        return out

    def is_add(self) -> np.ndarray:
        """Per-gate boolean mask on the host: True where the gate adds."""
        return np.asarray([op == ADD for op in self.ops])

    def add_mask(self, device) -> torch.Tensor:
        """``is_add`` as a bool tensor on ``device``: built at the first call
        for a device and kept, so a prover's tables read the gates' types
        without a pass over ``ops``."""
        key = torch.device(device)
        mask = self._add_masks.get(key)
        if mask is None:
            mask = torch.from_numpy(self.is_add()).to(key)
            self._add_masks[key] = mask
        return mask

    def get_add_mul_i(self, ctx: FieldCtx, op: str) -> MultilinearPoly:
        """One-hot wiring-predicate MLE for gates with operation ``op``."""
        size = 1 << self.bits_for_gates()
        table = np.zeros((size, ctx.num_words), dtype=np.uint32)
        positions = self.gate_positions()
        mask = np.asarray([o == op for o in self.ops])
        table[positions[mask]] = fb.tensor_to_words(ctx.one_mont)  # Montgomery 1
        return MultilinearPoly(ctx, ctx.to_device(table))


class Circuit:
    """A stack of layers; built from per-layer op lists like the reference's
    ``Circuit::new(Vec<Vec<Operation>>)`` (:113-125)."""

    def __init__(self, ctx: FieldCtx, structure: list[list[str]]):
        self.ctx = ctx
        self.layers = [Layer(ops) for ops in structure]
        self._masks = [layer.add_mask(ctx.device) for layer in self.layers]

    @property
    def num_layers(self) -> int:
        return len(self.layers)

    def evaluate(self, inputs: MultilinearPoly) -> list[MultilinearPoly]:
        """Feed-forward evaluation; returns every layer's outputs in input ->
        output order (reference :127-143)."""
        outputs = []
        current = inputs.table
        for layer, mask in zip(self.layers, self._masks):
            if current.shape[0] != 2 * layer.n_gates:
                raise ValueError(
                    f"layer expects {2 * layer.n_gates} inputs, got {current.shape[0]}"
                )
            current = layer_eval_kernel(self.ctx, current, mask)
            outputs.append(MultilinearPoly(self.ctx, current))
        return outputs

    def evaluate_ints(self, input_values: list[int]) -> list[list[int]]:
        inputs = MultilinearPoly.from_ints(self.ctx, input_values)
        return [layer.to_ints() for layer in self.evaluate(inputs)]

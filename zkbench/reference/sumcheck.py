"""The plain reference of the plain sumcheck over BN254 Fq (the Rust
reference's sum_check/src/sum_check_protocol.rs, ``prove`` at :25-52).

The prover absorbs the whole evaluation table, each entry as its canonical 32
little-endian bytes (``fq_vec_to_bytes``), then the claimed sum; each round it
sends [sum of the table's first half, sum of its second half], absorbs both,
draws the challenge r and folds the first variable (the table index's most
significant bit) to r: lo + r (hi - lo).

Arithmetic is ``field.py``'s 16-bit limbs in plain PyTorch, on any device. The
transcript is ``keccak.py``'s, hashed by ``keccak_native.py`` (its module says
why that one part is C).
"""

from __future__ import annotations

import numpy as np
import torch

from .field import PrimeField
from .keccak_native import Transcript

FQ = 21888242871839275222246405745257275088696311157297823662689037894645226208583


def table_bytes(F: PrimeField, table: torch.Tensor) -> bytes:
    """A Montgomery ``(16, n)`` table as the transcript takes it: each entry's
    canonical value, 32 bytes little-endian, entry after entry."""
    plain = F.mul(table, F.raw([1])).T.cpu().numpy()
    return np.ascontiguousarray(plain).astype("<u2").tobytes()


def prove(values: list[int], device, bind_claim: bool = True) -> dict:
    """The proof's values as plain Python: ``claimed_sum`` and ``round_polys``,
    each round's two half sums.

    ``bind_claim=False`` leaves the claimed sum out of the transcript: the
    control, a proof whose challenges do not bind the prover's claim."""
    F = PrimeField(FQ, device)
    table = F.from_ints(values)
    (claimed,) = F.sum_int(table[:, None, :])
    transcript = Transcript(FQ)
    transcript.append(table_bytes(F, table))
    if bind_claim:
        transcript.append_field_elements([claimed])
    rounds = []
    while table.shape[-1] > 1:
        half = table.shape[-1] // 2
        sums = F.sum_int(torch.stack([table[:, :half], table[:, half:]], dim=1))
        rounds.append(sums)
        transcript.append_field_elements(sums)
        table = F.fold(table, transcript.challenge())
    return {"claimed_sum": claimed, "round_polys": rounds}

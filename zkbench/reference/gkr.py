"""The plain reference of a layered GKR proof with its multilinear-KZG input
proof (the Rust reference's gkr/src/gkr_protocol.rs, pcs/src/kzg_pcs/kzg.rs),
over BLS12-381 Fr.

The circuit halves at every layer: gate g of a layer reads entries 2g and 2g+1
of the layer below and adds or multiplies them. A multilinear table's index
bit 0 is its most significant bit; folding binds it first.

The proof, as the reference defines it:

* the output layer, padded to two entries, is absorbed; its evaluation m_0 at a
  challenge r is absorbed and is the first layer's claim;
* each layer's sumcheck runs over f(b, c) = add(a, b, c) (w(b) + w(c)) +
  mul(a, b, c) w(b) w(c), with the gate index a bound to r (output layer) or
  folded as alpha add(r_b, ., .) + beta add(r_c, ., .) (later layers). A round
  sends the coefficients of its degree-2 polynomial, trailing zeros trimmed;
  the challenge follows. Rounds bind b's variables, then c's;
* w(r_b) and w(r_c) are absorbed, each followed by a challenge (alpha, beta),
  except after the input layer;
* the input table w is committed as w(tau) G1 (the Lagrange-basis SRS
  G1 eq(x, tau) summed with the table's entries), and opened at r_b and r_c:
  quotient k of an opening at z is q_k = f_k(1, .) - f_k(0, .), where f_k is
  the table less its value, with its first k variables bound to z; it is
  committed as q_k(tau_{k+1}, ..., tau_{n-1}) G1.

The sumcheck is computed the plain linear-time way: summed over c first,
f(b, .) = w(b) G(b) + H(b) with G(2g) = A_g + M_g w(2g+1), H(2g) = A_g w(2g+1);
then, with b bound, f(r_b, c) = A2(c) (w(r_b) + w(c)) + M2(c) w(r_b) w(c).
"""

from __future__ import annotations

import numpy as np
import torch

from . import curve
from .field import LIMBS, PrimeField
from .keccak import Transcript

FR = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
_INV2 = pow(2, -1, FR)


def round_coefficients(ys: list[int]) -> list[int]:
    """The degree-2 polynomial through (0, y0), (1, y1), (2, y2): its
    coefficients, lowest first, trailing zeros trimmed."""
    y0, y1, y2 = ys
    c2 = (y0 - 2 * y1 + y2) * _INV2 % FR
    c1 = (y1 - y0 - c2) % FR
    coefs = [y0 % FR, c1, c2]
    while coefs and coefs[-1] == 0:
        coefs.pop()
    return coefs


def evaluate_circuit(F: PrimeField, is_add: list[np.ndarray], inputs: list[int]):
    """Every layer's values, input layer first, Montgomery ``(16, n)``."""
    values = [F.from_ints(inputs)]
    for mask in is_add:
        w = values[-1]
        left, right = w[:, 0::2], w[:, 1::2]
        add = torch.from_numpy(np.asarray(mask, dtype=bool)).to(F.device)
        values.append(torch.where(add, F.add(left, right), F.mul(left, right)))
    return values


def _sumcheck_round(F: PrimeField, tables: torch.Tensor, pairs) -> list[int]:
    """y_t for t = 0, 1, 2 of sum over the half-cube of sum_j T_a(t) T_b(t)
    (+ T_c(t) for a triple): ``tables`` is ``(16, k, size)``, ``pairs`` lists
    the (a, b) or (a, b, c) table indices of each term."""
    half = tables.shape[-1] // 2
    lo, hi = tables[..., :half], tables[..., half:]
    two = F.add(hi, F.sub(hi, lo))
    at_t = torch.stack([lo, hi, two], dim=1)  # (16, 3, k, half)
    total = None
    for term in pairs:
        part = F.mul(at_t[:, :, term[0]], at_t[:, :, term[1]])
        if len(term) == 3:
            part = F.add(part, at_t[:, :, term[2]])
        total = part if total is None else F.add(total, part)
    return F.sum_int(total)


def _layer_sumcheck(F, transcript, w, coef_add, coef_mul, record):
    """One layer's 2k rounds; returns the challenges."""
    n = coef_add.shape[-1]
    k = int(w.shape[-1]).bit_length() - 1
    challenges = []

    def finish(ys, tables):
        coefs = round_coefficients(ys)
        record.append(coefs)
        transcript.append_field_elements(coefs)
        r = transcript.challenge()
        challenges.append(r)
        return F.fold(tables, r)

    w_odd = w[:, 1::2]
    zeros = torch.zeros_like(coef_add)
    g = torch.stack([F.add(coef_add, F.mul(coef_mul, w_odd)), zeros], dim=-1).reshape(LIMBS, 2 * n)
    h = torch.stack([F.mul(coef_add, w_odd), zeros], dim=-1).reshape(LIMBS, 2 * n)
    tables = torch.stack([w, g, h], dim=1)  # F, G, H
    for _ in range(k):
        tables = finish(_sumcheck_round(F, tables, [(0, 1, 2)]), tables)
    wb = tables[:, 0]  # w(r_b), (16, 1)

    eqb_even = F.eq_table(challenges)[:, 0::2]
    a2 = torch.stack([zeros, F.mul(coef_add, eqb_even)], dim=-1).reshape(LIMBS, 2 * n)
    m2 = torch.stack([zeros, F.mul(F.mul(coef_mul, eqb_even), wb)], dim=-1).reshape(LIMBS, 2 * n)
    tables = torch.stack([a2, F.add(w, wb), m2, w], dim=1)
    for _ in range(k):
        tables = finish(_sumcheck_round(F, tables, [(0, 1), (2, 3)]), tables)
    return challenges


def prove(is_add: list[np.ndarray], inputs: list[int], taus: list[int], device,
          bind_claims: bool = True) -> dict:
    """The proof's values as plain Python: ``output`` (the padded output
    layer), ``round_polys`` (per layer, each round's coefficients),
    ``claimed`` (w(r_b), w(r_c) of every layer but the input layer),
    ``opened`` (the input layer at r_b and r_c), ``commitment`` (under the
    secrets ``taus``) and ``quotients`` (two lists of G1 points, at r_b and at
    r_c).

    ``bind_claims=False`` leaves w(r_b) and w(r_c) out of the transcript: the
    control, a proof whose challenges do not bind the prover's claims."""
    F = PrimeField(FR, device)
    values = evaluate_circuit(F, is_add, inputs)
    output = values[-1]
    if output.shape[-1] == 1:
        output = torch.cat([output, torch.zeros_like(output)], dim=-1)
    out_ints = F.to_ints(output)
    transcript = Transcript(FR)
    transcript.append_field_elements(out_ints)
    r = transcript.challenge()
    claim = F.evaluate(output, [r])
    transcript.append_field_elements([claim])

    round_polys, claimed = [], []
    r_b, r_c, alpha, beta = [], [], 0, 0
    num_layers = len(is_add)
    for idx in range(num_layers):
        mask = torch.from_numpy(np.asarray(is_add[num_layers - 1 - idx], dtype=bool)).to(F.device)
        w = values[num_layers - 1 - idx]
        n = mask.shape[0]
        if idx == 0:
            coef = F.from_ints([1 - r, r])[:, :n]
        else:
            coef = F.add(F.mul(F.eq_table(r_b)[:, :n], F.const(alpha)),
                         F.mul(F.eq_table(r_c)[:, :n], F.const(beta)))
        zero = torch.zeros_like(coef)
        coef_add = torch.where(mask, coef, zero)
        coef_mul = torch.where(mask, zero, coef)
        record = []
        challenges = _layer_sumcheck(F, transcript, w, coef_add, coef_mul, record)
        round_polys.append(record)
        k = len(challenges) // 2
        r_b, r_c = challenges[:k], challenges[k:]
        o_1, o_2 = F.evaluate(w, r_b), F.evaluate(w, r_c)
        if idx < num_layers - 1:
            if bind_claims:
                transcript.append_field_elements([o_1])
            alpha = transcript.challenge()
            if bind_claims:
                transcript.append_field_elements([o_2])
            beta = transcript.challenge()
            claimed.append((o_1, o_2))

    w = values[0]
    return {"output": out_ints, "round_polys": round_polys, "claimed": claimed,
            "opened": [o_1, o_2],
            "commitment": curve.multiply(curve.G1, F.evaluate(w, taus)),
            "quotients": [_quotient_commitments(F, w, point, taus) for point in (r_b, r_c)]}


def _quotient_commitments(F, w, point, taus) -> list:
    table = w
    out = []
    for k, z in enumerate(point):
        half = table.shape[-1] // 2
        quotient = F.sub(table[:, half:], table[:, :half])
        out.append(curve.multiply(curve.G1, F.evaluate(quotient, taus[k + 1:])))
        table = F.fold(table, z)
    return out

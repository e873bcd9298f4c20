"""Fused lazy-GKR sumcheck phases: Fiat-Shamir ON the device.

The counterpart of ``zktpu/gkr/fused_lazy.py``, and the port's one
single-device prover of a lazy layer sumcheck (``gkr/lazy.py``'s ``LazyFbc``;
over a mesh, ``parallel.mesh.gkr_sumcheck_lazy_sharded``, which fetches each
round's sums and squeezes on the host). Each sumcheck PHASE keeps the Keccak
sponge on the device, so the host uploads the sponge state and its pending tail
(one copy), queues every round, and fetches the phase's coefficient rows once:

  * the phase's composed tables live as one contiguous (2, 2, size, W) product
    stack: [[F, G], [H, 1]] for phase 1 and [[A2, wb + w], [M2 wb, w]] for
    phase 2, each one launch (``gkr/tables.py``);
  * a round folds the stack at the last round's challenge, sums the folded
    stack's three lazy rows y_0, y_1, y_2, takes them to canonical coefficients
    (c0 = y0, c2 = (y0 - 2 y1 + y2)/2, c1 = y1 - y0 - c2), absorbs digest || the
    trimmed coefficients and gives the next challenge, which never visits the
    host (``gkr.kernels``);
  * as the reference does, a phase runs one ``gkr_big_round`` launch for each
    round whose table is above ``TAIL_MAX`` entries, then one
    ``gkr_phase_tail`` launch for all the remaining rounds and the last fold.

The reference's tail (``_scan_phase_fixed``) runs on a bit-reversed, zero-padded
stack of a fixed shape (``_bitrev_pad``, ``SCAN_SIZE``), which caps the
per-shape compilations of its tracing compiler; that has no counterpart here:
``gkr_phase_tail`` takes every power-of-two size from 2 as it is, in one
launch. ``TAIL_MAX`` is the port's own threshold, the table size up to which
one tail launch beats a launch a round on the card.

Transcript bytes are identical to the dense prover's INCLUDING the trim: the
reference absorbs ``interpolate``'s trailing-zero-trimmed coefficient vector,
and a vanishing quadratic coefficient is structural for some layers (all-ADD
wiring), not rare. Each round finds the trimmed length on the card, so no
round asks the host anything; in the first round of a phase, which also absorbs
the host transcript's pending tail, that length decides whether the content
takes one block or two.

After each device phase the host transcript replays the fetched coefficient
appends/squeezes (a few Keccak blocks), so the surrounding GKR protocol code
(alpha/beta folds, o_1/o_2 absorbs) continues unchanged.

With ``utils.tracker`` recording, a layer's host time splits into spans:
``gkr.tables`` (the phase stacks' launches and phase 2's upload), ``gkr.phase``
(queueing a phase's launches), ``gkr.fetch`` (waiting on its coefficient rows)
and ``gkr.replay`` (the host transcript); each phase records its least work
once (``roofline.gkr_phase_cost``), however ``TAIL_MAX`` splits it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field.torch_backend import FieldCtx
from ..hash import keccak_device as kd
from ..hash import kernels as tk
from ..poly.univariate import UnivariatePoly
from ..sumcheck.protocol import GkrSumcheckProof, _encode
from ..transcript import Transcript
from ..utils import roofline, tracker
from . import kernels as gk
from . import lazy as lazy_mod
from . import tables as gt

#: coefficients of a round polynomial before the trim
NUM_COEFFS = 3
#: rounds whose table is above this many entries take a ``gkr_big_round``
#: launch each; the rest of the phase takes one ``gkr_phase_tail`` launch. On
#: an H100 the walk's 40 phases took least time at 2^16 of 2^14 to 2^20
#: (``scripts/time_kernels.py``'s ``tail`` part): the tail's rounds above it,
#: on one block an SM, are slower than big rounds on two. A module attribute,
#: read at call time (tests force it down to run both kernels on a small
#: circuit); at least 2.
TAIL_MAX = 1 << 16


class _PhaseConsts:
    """What one phase uploads before its first kernel, in one copy: the host
    sponge's state (25 lanes) and its pending tail (whole lanes, under a
    block), as two views of one tensor."""

    def __init__(self, ctx: FieldCtx, state_lanes: np.ndarray, tail_lanes: np.ndarray):
        if tail_lanes.shape[0] > kd.RATE_LANES - 1:
            raise ValueError("a pending tail is under one block")
        packed = torch.from_numpy(np.concatenate([state_lanes, tail_lanes])).to(ctx.device)
        self.state = packed[: tk.STATE_LANES]
        self.tail = packed[tk.STATE_LANES :]


def _device_phase(ctx: FieldCtx, tables, consts: _PhaseConsts, ones: bool = False):
    """All rounds of one phase on the device, nothing fetched and nothing
    uploaded: ``consts`` holds every upload. A round above ``TAIL_MAX``
    entries is one ``gkr_big_round`` launch (its fold at the last round's
    challenge, its sums, its coefficients into the round's slot, the absorb,
    the next challenge); the rest of the phase is one ``gkr_phase_tail``.
    ``ones``: the stack's [1, 1] table is phase 1's constant ones, which the
    phase's work record (``roofline.gkr_phase_cost``) does not price.

    Returns ((nb, 3, W) canonical coefficient rows, (W,) the folded [0, 0]
    table's one entry -- w(r_b) after phase 1).
    """
    if TAIL_MAX < 2:
        raise ValueError(f"TAIL_MAX is {TAIL_MAX}: a phase tail takes at least one round")
    if tracker.recording:
        nbytes, ops, floor_ms = roofline.gkr_phase_cost(tables.shape[2], ones)
        tracker.work("gkr_phase", nbytes, ops, floor_ms * 1e6)
    nb = tables.shape[2].bit_length() - 1
    out = torch.empty((nb, NUM_COEFFS, ctx.num_words), dtype=torch.int32, device=ctx.device)
    state, tail, r = consts.state, consts.tail, None
    k = 0
    # round k sums a table of tables.shape[2] entries, halved first if it folds
    while tables.shape[2] >> (r is not None) > TAIL_MAX:
        tables, _, state, r = gk.gkr_big_round(ctx, tables, r, state,
                                               tail if k == 0 else None, out[k])
        k += 1
    _, wb, _ = gk.gkr_phase_tail(ctx, tables, r, state, tail if k == 0 else None, out[k:])
    return out, wb


def _run_phase(ctx: FieldCtx, transcript: Transcript, tables, ones: bool = False):
    """Queue one device phase, then replay its appends/squeezes on the host
    transcript (``ones`` as in ``_device_phase``). Returns (round polys,
    challenges, wb device row)."""
    nb = tables.shape[2].bit_length() - 1
    state_pairs, tail = transcript.sponge().state_lanes()
    if len(tail) % ctx.spec.byte_len:
        raise ValueError("transcript tail is not aligned to field elements")
    consts = _PhaseConsts(ctx, kd.pairs_to_lanes(state_pairs), kd.bytes_to_lanes(tail))
    with tracker.span("gkr.phase"):
        coeff_rows, wb = _device_phase(ctx, tables, consts, ones)
    with tracker.span("gkr.fetch"):
        ints = [int(v) for v in ctx.unpack(coeff_rows.reshape(-1, ctx.num_words))]
    polys, challenges = [], []
    with tracker.span("gkr.replay"):
        for k in range(nb):
            poly = UnivariatePoly(ctx.spec, ints[NUM_COEFFS * k : NUM_COEFFS * (k + 1)])
            poly.trim()  # match interpolate's trim (and the device absorb layout)
            transcript.append_field_elements(poly.coefficients)
            polys.append(poly)
            challenges.append(transcript.get_random_challenge())
    return polys, challenges, wb


def gkr_prove_lazy_fused(claimed_sum: int, fbc: "lazy_mod.LazyFbc",
                         transcript: Transcript) -> GkrSumcheckProof:
    """One layer's lazy sumcheck (``sumcheck.gkr_prove`` on the dense f(b,c),
    the same proof values) in two phases of device launches, one fetch a
    phase."""
    ctx = fbc.ctx
    if ctx.spec.byte_len != 32:
        raise ValueError("fused prover requires a 32-byte field (digest width)")
    nb = fbc.num_rounds // 2

    # ---- phase 1: [[F, G], [H, 1]] ---------------------------------------
    with tracker.span("gkr.tables"):
        tables1 = gt.phase1_stack(ctx, fbc.coef_a, fbc.coef_m, fbc.w_table)
    polys1, challenges1, wb = _run_phase(ctx, transcript, tables1, ones=True)

    # ---- phase 2 ----------------------------------------------------------
    with tracker.span("gkr.tables"):
        tables2 = gt.phase2_stack(ctx, fbc.coef_a, fbc.coef_m, fbc.w_table,
                                  _encode(ctx, challenges1), wb)
    polys2, challenges2, _ = _run_phase(ctx, transcript, tables2)

    if not len(polys1) == len(polys2) == nb:
        raise AssertionError("a phase returned the wrong number of rounds")
    return GkrSumcheckProof(
        polys1 + polys2, claimed_sum, challenges1 + challenges2
    )

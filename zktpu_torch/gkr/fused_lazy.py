"""Fused lazy-GKR sumcheck phases: Fiat-Shamir ON the device.

The counterpart of ``zktpu/gkr/fused_lazy.py``. The host-loop lazy prover
(``gkr.lazy.gkr_prove_lazy``) pays one device->host trip per round for the
transcript squeeze. Here each sumcheck PHASE keeps the Keccak sponge on the
device (the machinery of ``sumcheck.fused``), so the host uploads the sponge
state, queues every round, and fetches the phase's coefficient rows once:

  * the phase's composed tables live as one contiguous (2, 2, size, W) product
    stack: [[F, G], [H, 1]] for phase 1 and the ``_phase2_tables_kernel`` layout
    for phase 2;
  * per round: the ``gkr_round`` kernel gives y_0, y_1, y_2 as exact lazy rows,
    the device interpolates them to coefficients (c0 = y0,
    c2 = (y0 - 2 y1 + y2)/2, c1 = y1 - y0 - c2), absorbs one padded Keccak block
    (digest || coefficients), and the ``fold`` kernel folds the whole stack at
    the squeezed challenge, which never visits the host.

Every round goes through the same two kernels, whatever the table's size. The
reference switches, at and below 2^14 entries, to a bit-reversed zero-padded
fixed-shape scan (``_scan_phase_fixed``, ``_bitrev_pad``, ``_big_round``,
``SCAN_SIZE``); that exists only to cap the number of per-shape compilations of
its tracing compiler and has no counterpart here: this package runs eagerly and
its kernels take every power-of-two size from 2.

Transcript bytes are identical to the host path INCLUDING the trim: the
reference absorbs ``interpolate``'s trailing-zero-trimmed coefficient vector,
and a vanishing quadratic coefficient is structural for some layers (all-ADD
wiring), not rare. Coefficients past the trim are zero, so the block's content
does not depend on the trimmed length k; only the place of the padding does. It
is chosen on the device, by indexing a (4, lanes) table of the four static
layouts with k, so no round asks the host anything. The first round of a phase
also absorbs the host transcript's pending tail, and tail + 32k bytes may or may
not cross a 136-byte block: then both block counts are computed and the state
after the right one is selected on the device, at the cost of one spare
permutation in that round.

After each device phase the host transcript replays the fetched coefficient
appends/squeezes (a few Keccak blocks), so the surrounding GKR protocol code
(alpha/beta folds, o_1/o_2 absorbs) continues unchanged.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..field import kernels as fk
from ..field import torch_backend as fb
from ..field.spec import FieldSpec
from ..field.torch_backend import FieldCtx
from ..hash import keccak_device as kd
from ..poly.univariate import UnivariatePoly
from ..sumcheck import fused as fp
from ..sumcheck.protocol import GkrSumcheckProof, _encode
from ..transcript import Transcript
from . import lazy as lazy_mod

#: coefficients of a round polynomial before the trim
NUM_COEFFS = 3


@functools.lru_cache(maxsize=None)
def _inv2_mont_np(spec: FieldSpec, num_words: int) -> np.ndarray:
    """to_mont(1/2) as host words: mont_mul(x, this) == x/2 for canonical x."""
    p = spec.modulus
    value = pow(2, -1, p) * (spec.R % p) % p
    return np.frombuffer(value.to_bytes(4 * num_words, "little"), dtype="<u4").copy()


class _PhaseConsts:
    """What one phase uploads before its first kernel: the sponge state, the
    pending tail, the four padding layouts of each kind of absorb, the block
    count of the first absorb per trimmed length, and 1/2."""

    def __init__(self, ctx: FieldCtx, state_lanes: np.ndarray, tail_lanes: np.ndarray):
        tail_len = 8 * tail_lanes.shape[0]
        byte_len = ctx.spec.byte_len
        counts = [(tail_len + k * byte_len) // kd.RATE + 1 for k in range(NUM_COEFFS + 1)]
        #: host ints: the first absorb's block count is the same for every k
        #: unless these differ
        self.min_blocks, self.max_blocks = counts[0], counts[-1]

        def dev(arr):
            return torch.from_numpy(np.ascontiguousarray(arr)).to(ctx.device)

        self.state = dev(state_lanes)
        self.tail = dev(tail_lanes)
        self.tail_pads = dev(np.stack([
            fp._tail_block_pad(ctx, tail_len, k, self.max_blocks) for k in range(NUM_COEFFS + 1)
        ]))
        self.round_pads = dev(np.stack([fp._round_pad(ctx, k) for k in range(NUM_COEFFS + 1)]))
        self.last_block = dev(np.asarray(counts, np.int64) - 1)
        self.trim_index = dev(np.arange(1, NUM_COEFFS + 1, dtype=np.int64))
        self.inv2 = dev(_inv2_mont_np(ctx.spec, ctx.num_words).view(np.int32))


def _interp3(ctx: FieldCtx, ys_canon, inv2):
    """Canonical (3, W) y-values at t=0,1,2 -> canonical (3, W) coefficients
    [c0, c1, c2] of the unique degree-<=2 interpolant."""
    y0, y1, y2 = ys_canon[0], ys_canon[1], ys_canon[2]
    c2 = fk.mont_mul(
        ctx, fb.sub(ctx, fb.sub(ctx, fb.add(ctx, y0, y2), y1), y1), inv2
    )
    c1 = fb.sub(ctx, fb.sub(ctx, y1, y0), c2)
    return torch.stack([y0, c1, c2])


def _trim_len(coeffs, trim_index):
    """Trimmed length (0..3) of canonical (3, W) coefficient rows, as a (1,)
    int64 tensor on the device: highest index with a nonzero row, plus one."""
    nonzero = (coeffs != 0).any(dim=1)
    return torch.where(nonzero, trim_index, 0).max().reshape(1)


def _squeeze_trim(ctx: FieldCtx, digest, coeffs, consts: _PhaseConsts):
    """Squeeze-round absorb of digest || trimmed coefficients: the padding
    layout is picked by the trimmed length on the device."""
    pad = consts.round_pads.index_select(0, _trim_len(coeffs, consts.trim_index))[0]
    return fp._squeeze_round(ctx, digest, coeffs, pad)


def _absorb_tail_trim(ctx: FieldCtx, coeffs, consts: _PhaseConsts):
    """First absorb of a phase: prefix tail || trimmed coefficients."""
    k = _trim_len(coeffs, consts.trim_index)
    pad = consts.tail_pads.index_select(0, k)[0]
    content = fp._tail_content(ctx, consts.tail, coeffs, pad)
    state = consts.state
    states = []
    for b in range(consts.max_blocks):
        state = kd.absorb_block(state, content[kd.RATE_LANES * b : kd.RATE_LANES * (b + 1)])
        states.append(state)
    if consts.min_blocks == consts.max_blocks:
        return state
    # the trimmed content may end a block earlier: take the state after its last
    return torch.stack(states).index_select(0, consts.last_block.index_select(0, k))[0]


def _device_phase(ctx: FieldCtx, tables, consts: _PhaseConsts):
    """All rounds of one phase on the device, nothing fetched and nothing
    uploaded: ``consts`` holds every upload.

    Returns ((nb, 3, W) canonical coefficient rows, (W,) the folded [0, 0]
    table's one entry -- w(r_b) after phase 1).
    """
    outs = []
    digest = None
    for k in range(tables.shape[2].bit_length() - 1):
        rows = fk.gkr_round(ctx, tables)
        coeffs = _interp3(ctx, fp._canonicalize_rows(ctx, rows), consts.inv2)
        outs.append(coeffs)
        if k == 0:
            state = _absorb_tail_trim(ctx, coeffs, consts)
        else:
            state = _squeeze_trim(ctx, digest, coeffs, consts)
        digest = state[:4]
        tables = fk.fold(ctx, tables, fp._digest_to_mont(ctx, digest))
    return torch.stack(outs), tables[0, 0, 0]


def _run_phase(ctx: FieldCtx, transcript: Transcript, tables):
    """Queue one device phase, then replay its appends/squeezes on the host
    transcript. Returns (round polys, challenges, wb device row)."""
    nb = tables.shape[2].bit_length() - 1
    state_pairs, tail = transcript.sponge().state_lanes()
    if len(tail) % ctx.spec.byte_len:
        raise ValueError("transcript tail is not aligned to field elements")
    consts = _PhaseConsts(ctx, kd.pairs_to_lanes(state_pairs), kd.bytes_to_lanes(tail))
    coeff_rows, wb = _device_phase(ctx, tables, consts)
    ints = [int(v) for v in ctx.unpack(coeff_rows.reshape(-1, ctx.num_words))]
    polys, challenges = [], []
    for k in range(nb):
        poly = UnivariatePoly(ctx.spec, ints[NUM_COEFFS * k : NUM_COEFFS * (k + 1)])
        poly.trim()  # match interpolate's trim (and the device absorb layout)
        transcript.append_field_elements(poly.coefficients)
        polys.append(poly)
        challenges.append(transcript.get_random_challenge())
    return polys, challenges, wb


def gkr_prove_lazy_fused(claimed_sum: int, fbc: "lazy_mod.LazyFbc",
                         transcript: Transcript) -> GkrSumcheckProof:
    """Drop-in replacement for ``lazy.gkr_prove_lazy``: same proof values, two
    fetches per layer instead of one per round."""
    ctx = fbc.ctx
    if ctx.spec.byte_len != 32:
        raise ValueError("fused prover requires a 32-byte field (digest width)")
    nb = fbc.num_rounds // 2

    # ---- phase 1: [[F, G], [H, 1]] ---------------------------------------
    gh = lazy_mod._phase1_tables_kernel(ctx, fbc.coef_a, fbc.coef_m, fbc.w_table)
    ones = ctx.one_mont.expand(fbc.w_table.shape)
    tables1 = torch.stack([
        torch.stack([fbc.w_table, gh[0]]), torch.stack([gh[1], ones])
    ])
    polys1, challenges1, wb = _run_phase(ctx, transcript, tables1)

    # ---- phase 2 ----------------------------------------------------------
    eqb = lazy_mod.eq_tensor(ctx, _encode(ctx, challenges1))
    tables2 = lazy_mod._phase2_tables_kernel(
        ctx, fbc.coef_a, fbc.coef_m, fbc.w_table, eqb, wb
    )
    polys2, challenges2, _ = _run_phase(ctx, transcript, tables2)

    if not len(polys1) == len(polys2) == nb:
        raise AssertionError("a phase returned the wrong number of rounds")
    return GkrSumcheckProof(
        polys1 + polys2, claimed_sum, challenges1 + challenges2
    )

"""Sumcheck prover with the Fiat-Shamir transcript ON the device.

The counterpart of ``zktpu/sumcheck/fused.py``. The host-loop prover
(``protocol.prove``) pays one device->host round trip per round for the
transcript squeeze -- the protocol's inherent serial dependency. Here the Keccak
sponge state lives on the device and each round's transcript step is one
launch of ``hash.kernels.round_step``: it absorbs the round's sums and computes
the next challenge from the digest, which the fold kernel reads as a device
pointer. The host sees exactly two device interactions: it uploads the
partially-absorbed sponge state with its pending tail (one copy), and it fetches
the n round polynomials. Between the two, ``prove`` makes no synchronising
call.

Every round goes through the same kernels: ``halves_sums`` for round 0, then
``fold_and_halves`` for each later round, whatever the table's size. The
reference switches, below 2^16 entries, to a bit-reversed fixed-shape scan
(``_scan_rounds``, ``SCAN_SIZE``, ``_bitrev``); that tail exists only to cap the
number of per-shape kernel compilations of its tracing compiler, and has no
counterpart here: this package runs eagerly and its kernels take every
power-of-two size. The sums are exact integers either way, so the proof is the
same.

Byte/bit-exactness: identical proofs to ``protocol.prove``. The transcript
protocol is the reference's (fiat_shamir_transcript.rs:19-29): after each
squeeze the buffered bytes are digest(32) || half_sums(64) = 96 bytes -- one
padded Keccak block -- so every round costs exactly one keccak-f[1600], inside
its ``round_step``. Round 0 continues the host-absorbed prefix (table bytes + claimed sum,
hashed at native speed by the C backend) from its exported sponge state.

Under ``tracker.record(True)`` a proof records four spans, none inside another:
``sumcheck.claim`` (the canonical table and its sum), ``sumcheck.absorb`` (the
transcript prefix), ``sumcheck.rounds`` (the rounds queued) and
``sumcheck.fetch`` (the one wait, for the round rows); and one
``sumcheck_round`` work record a round, priced by ``utils.roofline``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import kernels as fk
from ..field.host import vec_to_bytes
from ..field.torch_backend import FieldCtx
from ..hash import keccak_device as kd
from ..hash import kernels as tk
from ..poly.multilinear import MultilinearPoly
from ..utils import roofline, tracker
from .protocol import Proof

#: field elements absorbed per round: the two half-sums
ROUND_ELEMS = 2


def host_sum_mod_p(ctx: FieldCtx, canonical: np.ndarray) -> int:
    """Exact sum of a canonical (size, W) word table, mod p (numpy columns +
    one Python carry pass -- no device round trip)."""
    cols = np.sum(canonical, axis=0, dtype=np.uint64)
    return sum(int(c) << (32 * i) for i, c in enumerate(cols)) % ctx.spec.modulus


#: a round's canonical sums and its challenge from a digest, round_step's first
#: and last steps on their own (plain PyTorch), under zktpu's names; no prover
#: calls them: they are kept for tests/test_torch_sumcheck.py, which holds them
#: against zktpu's functions of the same names
_canonicalize_rows = tk.canonical_rows_plain
_digest_to_mont = tk.digest_to_mont_plain


def _round_work(entries: int, num_words: int, tail_lanes: int | None) -> None:
    """Record the least work of one round on a table of ``entries``: round 0
    (``tail_lanes``, the uploaded tail's lanes) sums it, a later round (None)
    folds it and sums the half; then its ``round_step``. The floor is the
    ``round_step`` chain, since each round waits on the last one's challenge."""
    if tail_lanes is not None:
        nbytes, ops = roofline.halves_sums_cost(entries, num_words)
        step = roofline.round_step_cost(ROUND_ELEMS, tail_lanes, first=True)
    else:
        nbytes, ops = roofline.fold_and_halves_cost(entries, num_words)
        step = roofline.round_step_cost(ROUND_ELEMS)
    tracker.work("sumcheck_round", nbytes + step[0], ops + step[1],
                 roofline.one_thread_ms(step[1]) * 1e6)


def _device_prove(ctx: FieldCtx, num_vars: int, state0, tail_lanes, table):
    """All rounds on the device, nothing fetched. ``state0`` (25,) and
    ``tail_lanes`` are host int64 lane arrays, uploaded together before the
    first kernel. A round is two launches: ``halves_sums`` (round 0) or
    ``fold_and_halves`` at the last challenge, then ``round_step``, which
    writes the round's canonical sums into its slot of the output, absorbs them
    and gives the next challenge. Returns (num_vars, 2, W) canonical word rows
    of every round polynomial, on the device."""
    packed = torch.from_numpy(np.concatenate([state0, tail_lanes])).to(ctx.device)
    state, tail = packed[: tk.STATE_LANES], packed[tk.STATE_LANES :]
    out = torch.empty((num_vars, ROUND_ELEMS, ctx.num_words), dtype=torch.int32,
                      device=ctx.device)
    r_mont = None
    for k in range(num_vars):
        if tracker.recording:
            _round_work(table.shape[0], ctx.num_words, tail.shape[0] if k == 0 else None)
        if k == 0:
            rows = fk.halves_sums(ctx, table)
        else:
            table, rows = fk.fold_and_halves(ctx, table, r_mont)
        _, state, r_mont = tk.round_step(ctx, rows, state, tail if k == 0 else None, out[k])
    return out


def prove(poly: MultilinearPoly) -> Proof:
    """Fused prover; proof bytes identical to ``protocol.prove``."""
    ctx = poly.ctx
    spec = ctx.spec
    if spec.byte_len != 32:
        raise ValueError("fused prover requires a 32-byte field (digest width)")
    if poly.num_vars == 0:
        raise ValueError("fused prover needs at least one variable")
    with tracker.span("sumcheck.claim"):
        claimed_sum = host_sum_mod_p(ctx, poly.canonical_table())
    with tracker.span("sumcheck.absorb"):
        sponge = poly.transcript_sponge()
        sponge.absorb(vec_to_bytes(spec, [claimed_sum]))
        state_pairs, tail = sponge.state_lanes()
    if len(tail) % 8:
        raise ValueError("transcript prefix is not lane aligned")

    with tracker.span("sumcheck.rounds"):
        rows = _device_prove(
            ctx, poly.num_vars, kd.pairs_to_lanes(state_pairs), kd.bytes_to_lanes(tail),
            poly.table,
        )
    with tracker.span("sumcheck.fetch"):
        ints = [int(v) for v in ctx.unpack(rows.reshape(-1, ctx.num_words))]
    proof_polynomials = [
        [ints[2 * k], ints[2 * k + 1]] for k in range(poly.num_vars)
    ]
    return Proof(proof_polynomials, claimed_sum)

"""Sumcheck prover with the Fiat-Shamir transcript ON the device.

The counterpart of ``zktpu/sumcheck/fused.py``. The host-loop prover
(``protocol.prove``) pays one device->host round trip per round for the
transcript squeeze -- the protocol's inherent serial dependency. Here the Keccak
sponge state lives on the device (``zktpu_torch.hash.keccak_device``) and the
challenge of each round is computed there from the digest and handed to the
fold kernel as a device pointer. The host sees exactly two device interactions:
it uploads the partially-absorbed sponge state (with the static padding
vectors), and it fetches the n round polynomials. Between the two, ``prove``
makes no synchronising call.

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
padded Keccak block -- so every round costs exactly one keccak-f[1600] on the
device. Round 0 continues the host-absorbed prefix (table bytes + claimed sum,
hashed at native speed by the C backend) from its exported sponge state.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import kernels as fk
from ..field import torch_backend as fb
from ..field.host import vec_to_bytes
from ..field.torch_backend import FieldCtx
from ..hash import keccak_device as kd
from ..poly.multilinear import MultilinearPoly
from .protocol import Proof

#: field elements absorbed per round: the two half-sums
ROUND_ELEMS = 2

_TOP_BIT = -(1 << 63)  # the int64 whose only set bit is bit 63


def host_sum_mod_p(ctx: FieldCtx, canonical: np.ndarray) -> int:
    """Exact sum of a canonical (size, W) word table, mod p (numpy columns +
    one Python carry pass -- no device round trip)."""
    cols = np.sum(canonical, axis=0, dtype=np.uint64)
    return sum(int(c) << (32 * i) for i, c in enumerate(cols)) % ctx.spec.modulus


def _canonicalize_rows(ctx: FieldCtx, rows):
    """(k, W+1) exact word sums of Montgomery entries -> (k, W) canonical words
    of the underlying field value.

    The integer row is S = lo + hi * 2^(32 W) with lo the low W words; S is
    to_mont(sum) as an *unreduced* integer. The plain value is
    S * R^{-1} = lo * R^{-1} + hi, so one ``mont_mul(lo, 1)`` (CIOS bound:
    t < lo/R + p < 2p for any lo < 2^(32 W)) plus ``hi`` (< 2^32 < p, already
    canonical) and a modular add.
    """
    w = ctx.num_words
    lo = rows[:, :w].contiguous()
    hi = torch.nn.functional.pad(rows[:, w:], (0, w - fk.EXTRA_WORDS))
    return fb.add(ctx, fk.from_mont(ctx, lo), hi)


def _digest_to_mont(ctx: FieldCtx, digest_lanes):
    """(4,) digest lanes -> Montgomery words of from_le_bytes_mod_order: the
    raw 256-bit digest times R^2 (CIOS takes a left operand below R)."""
    return fk.to_mont(ctx, kd.lanes_to_limbs(digest_lanes))


def _tail_block_pad(ctx: FieldCtx, tail_len: int, num_elems: int = ROUND_ELEMS,
                    nblocks: int | None = None) -> np.ndarray:
    """Padding lanes of a first absorb (static layout, host array): prefix tail
    || ``num_elems`` field elements || 0x01 .. 0x80. ``nblocks`` lays the result
    out over more blocks than the content needs (the lanes past its last block
    stay zero), so layouts of different lengths can share one shape."""
    total = tail_len + num_elems * ctx.spec.byte_len
    used = total // kd.RATE + 1
    pad = np.zeros(kd.RATE_LANES * (used if nblocks is None else nblocks), np.int64)
    pad[total // 8] ^= 0x01
    pad[kd.RATE_LANES * used - 1] ^= _TOP_BIT
    return pad


def _round_pad(ctx: FieldCtx, num_elems: int = ROUND_ELEMS) -> np.ndarray:
    """Padding lanes of a steady-state round, over the whole 25-lane state (host
    array): digest(32B) || ``num_elems`` elements || 0x01 .. 0x80 in one block."""
    nlanes = 4 + num_elems * ctx.spec.byte_len // 8
    if nlanes > kd.RATE_LANES - 1:
        raise ValueError("round content must fit one Keccak block")
    pad = np.zeros(25, np.int64)
    pad[nlanes] = 0x01
    pad[kd.RATE_LANES - 1] ^= _TOP_BIT
    return pad


def _tail_content(ctx: FieldCtx, tail_lanes, canon, pad):
    """Padded lanes of a first absorb: prefix tail || canon's field elements ||
    zeros, xor ``pad`` (``canon`` is (k, W) canonical word rows; ``pad`` a device
    copy of ``_tail_block_pad``)."""
    used = tail_lanes.shape[0] + canon.numel() // 2
    return torch.cat([
        tail_lanes,
        kd.limbs_to_lanes(canon).reshape(-1),
        torch.zeros(pad.shape[0] - used, dtype=torch.int64, device=ctx.device),
    ]) ^ pad


def _absorb_tail_block(ctx: FieldCtx, state, tail_lanes, canon, pad):
    """Round-0 absorb: every block of ``_tail_content``."""
    content = _tail_content(ctx, tail_lanes, canon, pad)
    for b in range(pad.shape[0] // kd.RATE_LANES):
        state = kd.absorb_block(
            state, content[kd.RATE_LANES * b : kd.RATE_LANES * (b + 1)]
        )
    return state


def _squeeze_round(ctx: FieldCtx, digest, canon, pad):
    """Steady-state round: one padded block = digest(32B) || canon's elements,
    absorbed into a fresh (all-zero) sponge, so the block IS the state. Rows of
    ``canon`` past the padding's place must be zero."""
    used = digest.shape[0] + canon.numel() // 2
    block = torch.cat([
        digest,
        kd.limbs_to_lanes(canon).reshape(-1),
        torch.zeros(25 - used, dtype=torch.int64, device=ctx.device),
    ]) ^ pad
    return kd.keccak_f(block)


def _device_prove(ctx: FieldCtx, num_vars: int, state0, tail_lanes, table):
    """All rounds on the device, nothing fetched. ``state0`` (25,) and
    ``tail_lanes`` are host int64 lane arrays. Returns (num_vars, 2, W)
    canonical word rows of every round polynomial, on the device."""
    # every upload happens here, before the first kernel
    tail_pad = torch.from_numpy(_tail_block_pad(ctx, 8 * tail_lanes.shape[0])).to(ctx.device)
    round_pad = torch.from_numpy(_round_pad(ctx)).to(ctx.device)
    state = torch.from_numpy(state0).to(ctx.device)
    tail = torch.from_numpy(tail_lanes).to(ctx.device)

    outs = []
    digest = None
    for k in range(num_vars):
        if k == 0:
            rows = fk.halves_sums(ctx, table)
        else:
            r_mont = _digest_to_mont(ctx, digest)
            table, rows = fk.fold_and_halves(ctx, table, r_mont)
        canon = _canonicalize_rows(ctx, rows)
        outs.append(canon)
        if k == 0:
            state = _absorb_tail_block(ctx, state, tail, canon, tail_pad)
        else:
            state = _squeeze_round(ctx, digest, canon, round_pad)
        digest = state[:4]
    return torch.stack(outs)


def prove(poly: MultilinearPoly) -> Proof:
    """Fused prover; proof bytes identical to ``protocol.prove``."""
    ctx = poly.ctx
    spec = ctx.spec
    if spec.byte_len != 32:
        raise ValueError("fused prover requires a 32-byte field (digest width)")
    if poly.num_vars == 0:
        raise ValueError("fused prover needs at least one variable")
    claimed_sum = host_sum_mod_p(ctx, poly.canonical_table())
    sponge = poly.transcript_sponge()
    sponge.absorb(vec_to_bytes(spec, [claimed_sum]))
    state_pairs, tail = sponge.state_lanes()
    if len(tail) % 8:
        raise ValueError("transcript prefix is not lane aligned")

    rows = _device_prove(
        ctx, poly.num_vars, kd.pairs_to_lanes(state_pairs), kd.bytes_to_lanes(tail),
        poly.table,
    )
    ints = [int(v) for v in ctx.unpack(rows.reshape(-1, ctx.num_words))]
    proof_polynomials = [
        [ints[2 * k], ints[2 * k + 1]] for k in range(poly.num_vars)
    ]
    return Proof(proof_polynomials, claimed_sum)

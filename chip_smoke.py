#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``zktpu_torch``): run it on one GPU.

    python3 chip_smoke.py

It needs one CUDA device and ``nvcc``; with no card it exits non-zero at once.
It checks and does not time: the benchmark (``zkbench/``) times the paths, and
``scripts/time_kernels.py`` a kernel alone. It builds the CUDA kernels from
``zktpu_torch/csrc/`` (one ``nvcc`` a source, all started together), then

  1. prints the card's name and power limit and the host Keccak backend (the
     pure-Python one is refused), and fails on a kernel that spills registers;
  2. holds each kernel against its plain PyTorch version on the card, word for
     word (tolerance 0: this is integer arithmetic), for BN254 Fq and BLS12-381
     Fr at sizes from 2 to 2^20 and BLS12-381 Fq (12 words) up to 4096, with
     edge values and unreduced operands, and gkr_round on stacks of p - 1 at
     2^20 (its column sums at their largest); halves_sums and fold_and_halves at
     every power of two from 2 to 2^20 (BLS12-381 Fq to 2^12), halves_sums on
     raw words and on tables of all-ones words up to 2^24, fold_and_halves at
     r = 0, 1, p - 1, R mod p and a random r, and each of the two twice back to
     back on three grids (the tickets that elect the last blocks); the two G1
     point kernels at widths 1,
     2, 33, 127, 128, 129, 4096 and 2^20 with infinite, equal, opposite and
     re-scaled operands and coordinates 0, 1 and p - 1 mixed in, point_double
     repeated 1, 2 and 16 times (2^20: once);
  3. drives the first main path at full size through the public entry points:
     the sumcheck prove + verify of a 2^20-entry BN254 Fq multilinear polynomial
     (``MultilinearPoly.from_ints`` -> ``sumcheck.fused.prove`` ->
     ``sumcheck.protocol.verify``), reads the kernels' launch counts, and proves
     and verifies it WARM_RUNS times more, each proof equal to the first;
  4. ties the proof to the JAX reference package: it must equal the host-loop
     prover's, hash to a stored digest, and a 2^12 proof must equal the CPU's;
     a tampered proof must be refused;
  5. drives the second main path at full size: the GKR layer walk of a halving
     circuit of 2^20 inputs and 2^20 - 1 random add/mul gates over BLS12-381 Fr
     (``Circuit.evaluate`` -> ``gkr.protocol.prove_layers``, lazy and fused by
     default -> ``gkr.protocol.verify_layers``), reads the launch counts again,
     checks the input layer's two evaluations and two tampered proofs, and
     proves and verifies it WARM_RUNS times more, the last proof equal to the
     first;
  6. ties the GKR proof: the dense one equals the lazy one at 2^8 inputs, the
     card's equals the CPU's at 2^10, and the 2^16 proof hashes to a stored
     digest;
  8. drives the third main path at full size: the whole GKR proof of the same
     2^20-input circuit with its multilinear-KZG input proof
     (``gkr.protocol.prove`` -> ``gkr.protocol.verify``: the SRS comb, the
     Pippenger MSMs of the commitment and of the 2 x 20 quotients, the host's
     pairings), reads the launch counts of the kernels (a compaction round is
     one run_scan and one compact_add launch, 171 in all; the window combines
     two horner launches, the commitment's and all 20 quotient steps' chains
     in one; no point_double), refuses a tampered quotient point, commitment
     and opened evaluation, and proves it WARM_RUNS times more, the last input
     proof equal to the first and its opening at r_b accepted by ``KZG.verify``;
  9. ties the input proof without a reference run: the taus are known, so the
     commitment, every quotient commitment and some SRS entries must be the
     host's scalar multiples of G1; the comb equals the ladder and Pippenger the
     bit-split MSM at 2^10; a 2^6 proof on the card equals the CPU's; the 2^5
     proof hashes to a stored digest;
 11. holds the two NTT kernels against their plain versions on BN254 Fr tables
     with 0, 1, r - 1 and R mod r entries, forward and inverse twiddles:
     ``ntt_phase1`` at every size from 1 to 2^22 entries and every tile it
     takes there, ``ntt_stage`` at every stage of 2^12, 2^20 and 2^22; the
     card's twiddle table equals the CPU's;
 12. drives the fourth main path: ``ntt.ntt`` forward and inverse on 2^20- and
     2^22-entry tables (values below 2^256 from numpy seed 0, reduced by
     ``to_mont``), then ``fft_evaluate`` -> ``fft_interpolate`` at 2^20 through
     host ints; checks the launches of each call, the round trips, four outputs
     against the host's Horner evaluation, and the card's 2^12 transforms
     against the CPU's.

(Phases 7, 10 and 13 timed the paths and kernels; the others keep their
numbers, which the tests and documents cite.) Before (14), the profiler counts
the device kernels of phase 3's fused prove (at most 3 a round + 10) and of a
fused GKR phase of 2^10 entries (one, its ``gkr_phase_tail``) and of 2^20 (a
``gkr_big_round`` a round above ``fused_lazy.TAIL_MAX`` entries, and a tail).
Then (14) each of the four paths runs once more under ``torch.profiler``: on
each path the device runs one kernel a launch of ``halves_sums``,
``fold_and_halves``, ``round_step``, ``keccak_f``, ``gkr_big_round``,
``gkr_phase_tail``, the three GKR table kernels, ``compact_add`` and ``horner``,
two of ``run_scan``; the sumcheck a ``round_step`` a round; the GKR paths a
``gkr_big_round`` a round above ``fused_lazy.TAIL_MAX`` entries and a
``gkr_phase_tail`` a phase, and no ``gkr_round``, ``finish_rows`` or
``round_step``; no path a ``keccak_f``, and no device kernel of ``torch.cummax``
or ``torch.searchsorted`` (named as a profile of each op on the card shows
them), or the script fails. Last,

 15. proof bytes and the field oracle: ``mont_mul``, ``fold``, ``halves_sums``,
     ``fold_and_halves``, ``pow_static`` and ``inverse`` on the card against
     the host C++ oracle (``zktpu_torch.oracle``, no code shared with them) on
     2^12 random elements with 0, 1 and p - 1, exactly, for BN254 Fq and Fr and
     BLS12-381 Fr (BLS12-381 Fq: ``mont_mul``); the 2^20 sumcheck proof of
     phase 3 as bytes (``serialize``), which must hash to a stored digest and
     round-trip; the whole GKR proof of phase 8, encoded while it existed,
     decoded onto the card, equal to the proof in memory, re-encoded to the same
     bytes and accepted by ``gkr.verify``; three blobs with one byte changed (a
     field element, a G1 flag, a length prefix) raise ``ValueError`` on decode
     or are refused; both blobs hashed on the card too (``keccak256_device``,
     a ``keccak_f`` launch a block), equal to the host's digests.

 16. the mesh paths (``zktpu_torch.parallel``): the batched NTT kernels (a
     batch of tables in one launch: 2^10 rows of 2^10, 2^11 of 2^11, 3 of
     2^12, rows of 1, 2 and 4 entries) against their plain versions, word for
     word; then, on a mesh of 4 slots of the one card and on the mesh of every
     card present: ``sumcheck_prove_sharded`` of phase 3's table equals phase
     3's proof and digest; ``ntt_sharded`` forward and inverse at 2^20 and 2^22
     equals phase 12's outputs and inputs; ``msm_pippenger_sharded`` and the
     ladder ``msm_sharded`` (the path that runs ``point_double``) of the
     2^20-point commitment equal phase 8's commitment; on the 4-slot mesh
     ``gkr.prove(mesh=...)`` of phase 8's circuit (its layer sumchecks on the
     sharded prover) encodes to phase 8's bytes (phase 15's blob), and once more
     under the profiler it runs no cummax or searchsorted kernel and one device
     kernel a launch of the MSM kernels; ``dryrun_multichip`` passes; every
     kernel the mesh paths need is launched.
 17. the transcript kernels: ``keccak_f`` against its plain version on 1, 33
     and 4096 random states, ``round_step`` on 2 and 3 lazy rows (trimmed
     lengths 0-3, steady rounds and first rounds of one and two blocks, low
     words at or above p, digests at or above p) for BN254 Fq and BLS12-381 Fr,
     word for word.
 18. the MSM kernels: ``run_scan`` against its plain version at 1, 2, 3 and
     from 127 to 2^24 keys (random runs, all equal, all distinct, runs that
     cross the scan's tiles, MAXKEY tails; ``l_next`` below, at and
     above the survivor count), ``compact_add`` on the same keys (tiles of
     additions only, of copies only, of pads) at every width, with equal,
     opposite and infinite neighbours planted, ``horner`` at 1, 2 and 4
     segments and c = 4, 8 (the top 8 windows), 16 (all) on the window sums
     of real MSMs with infinities mixed in, and ``horner_groups`` on the 20
     quotient steps' shapes (2 segments, c = 16, 8 x 9, 4 x 10; the same cut
     of windows) in one launch, word for word; the cooperative lanes' Fq
     product (``fq_mul_coop``) against the oracle on phase 15's values; then on
     the commitment MSM of phase 8, its first compaction round (2^24 keys) and
     a steady one against their plain versions and the eager round they
     replaced, and whole Horner chains (the commitment's, and two segments at
     c = 16, 8 and 4) against the eager chain.
 19. the fused GKR phase kernels: ``gkr_big_round`` against its plain version
     on stacks of 2^15 to 2^20 entries, a phase's first round and a steady one,
     tables whose rounds trim to 0-3 coefficients, and three rounds back to
     back at 2^20 / 2^15 / 2^20; ``gkr_phase_tail`` from every size 2 to
     ``TAIL_MAX``, from a phase's first round and after a pending fold, pending
     tails of one and two blocks, at ``gkr.kernels.BLOCK_MAX`` (grid rounds,
     then block rounds) and, up to 2^12 entries, at four forced ones (grid
     rounds only, and the switch at 2^2, 2^9 and 2^10), word for word.
 20. the GKR layer-table kernels: ``gkr_wiring``, ``gkr_phase1_stack`` and
     ``gkr_phase2_stack`` against their plain versions (the eager chains they
     replace) at every layer size of the 2^20-input walk, 2^0 to 2^19 gates,
     mismatched words 0.

Any failed comparison exits non-zero. The last line of the output is one JSON
object, ``{"ok": true, "checks": N, "device": {...}}``, N the ``check`` calls
that ran; the line before it lists the sixteen kernels that replace zktpu's TPU
kernels with their launch counts (the four paths and phases 15 and 16) and
largest errors against their plain versions. The plain sumcheck's transcript is
``round_step``'s, a launch a round (phase 3); a GKR phase is ``gkr_big_round``
and ``gkr_phase_tail`` launches, whose rounds run the same transcript step
inside them (phase 5); neither makes a ``mont_mul`` or permutation of its own.
"""

from __future__ import annotations

import copy
import json
import os
import re
import struct
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from zktpu_torch import _build, oracle
from zktpu_torch import serialize as ser
from zktpu_torch.curve import bls12_381 as hc
from zktpu_torch.curve import device as dc
from zktpu_torch.curve import point_kernels as pk
from zktpu_torch.field import kernels as fk
from zktpu_torch.field import torch_backend as fb
from zktpu_torch.field.host import vec_to_bytes
from zktpu_torch.field.spec import BLS12_381_FQ, BLS12_381_FR, BN254_FQ, BN254_FR
from zktpu_torch.gkr import fused_lazy
from zktpu_torch.gkr import kernels as gk
from zktpu_torch.gkr import lazy as gkr_lazy
from zktpu_torch.gkr import protocol as gkr
from zktpu_torch.gkr import tables as gt
from zktpu_torch.gkr.circuit import ADD, MUL, Circuit
from zktpu_torch.hash import keccak as hk
from zktpu_torch.hash import keccak_device as kd
from zktpu_torch.hash import kernels as tk
from zktpu_torch.msm import fixed_base, generator_comb_mul, msm_bitsplit
from zktpu_torch.msm import kernels as mk
from zktpu_torch.msm import pippenger as pp
from zktpu_torch.ntt import ntt as tn
from zktpu_torch.ntt import ntt_kernels as nk
from zktpu_torch.parallel import context as pctx
from zktpu_torch.parallel import mesh as pm
from zktpu_torch.parallel.dryrun import dryrun_multichip
from zktpu_torch.pcs.kzg import KZG
from zktpu_torch.poly.multilinear import MultilinearPoly
from zktpu_torch.poly.univariate import UnivariatePoly
from zktpu_torch.sumcheck import fused, protocol
from zktpu_torch.transcript import Transcript

NUM_VARS = 20
#: Keccak-256 of vec_to_bytes(claimed_sum, round polynomials) of the seed-0
#: 2^20 BN254 Fq proof, from the port's CPU path (scripts/proof_digest.py), which
#: the tests pin to the JAX package; the JAX package's own fused prover gives the
#: same digest on the CPU.
PROOF_DIGEST_2E20 = "f23438ab206af9a6f85c866807dfeb3e1b97df970b09806663a29bae9218ff91"

#: the GKR path: a halving circuit of 2^GKR_NUM_VARS inputs over BLS12-381 Fr
GKR_NUM_VARS = 20
#: Keccak-256 over the seed-7 2^16-input GKR layer proof (``gkr_proof_digest``),
#: from the port's CPU path (scripts/proof_digest.py --gkr), which the tests pin
#: to the JAX package at small sizes
GKR_DIGEST_INPUTS = 16
GKR_PROOF_DIGEST_2E16 = "4bb880844e020faf4c5cb2f0fd2fda15c94c0a96144c5b3f136baf3952e54805"

#: the KZG path proves the GKR circuit of 2^GKR_NUM_VARS inputs whole; the
#: stored digest is over the commitment and the 2 x 5 quotient points of the
#: seed-7 2^5-input proof, from the port's CPU path (scripts/proof_digest.py
#: --kzg), which a test pins to the JAX package at that very input
KZG_DIGEST_INPUTS = 5
KZG_PROOF_DIGEST_2E5 = "837861d0924181c2346ccf1a1c8a3d51fa09b51d07073b3b8a97a9bb9e0117a7"
KZG_CPU_TIE_INPUTS = 6
#: the comb against the ladder, and Pippenger (each window width) against the
#: bit-split MSM, at this many lanes
MSM_TIE_LANES = 1 << 10
MSM_TIE_WINDOWS = (4, 8, 16)

CHECK_SIZES = (2, 4, 64, 4096, 1 << 20)
#: halves_sums and fold_and_halves against their plain versions at every power
#: of two up to these (log2 size), by field
SUM_CHECK_LOGS = ((BN254_FQ, 20), (BLS12_381_FR, 20), (BLS12_381_FQ, 12))
#: halves_sums on tables whose every word is 0xFFFFFFFF (column sums at their
#: largest), log2 size; the 12-word field at the last of SUM_CHECK_LOGS
ALL_ONES_LOGS = (12, 20, 24)
#: each one-launch kernel twice back to back at these sizes (log2), with the
#: wrapper's own grid, with this many blocks a row, and on the one-block grid
TICKET_LOGS = (13, 20)
TICKET_BLOCKS = 7
POINT_CHECK_WIDTHS = (1, 2, 33, 127, 128, 129, 4096, 1 << 20)
#: point_double's repeat counts held against the plain version up to 4096 lanes
#: (a plain doubling of 2^20 lanes takes some 0.4 s: there only once)
POINT_DOUBLE_TIMES = (1, 2, 16)
#: point_add launches of the 2^20-input gkr.prove: the comb's 31, the basis
#: chain's 20 folds, and the bucket reductions' Kogge-Stone and pair steps,
#: 2 (c - 1) a Pippenger call (``kzg_expected_msm_launches``). Before the
#: compaction and the window combine had their kernels: 1,407, of which 939
#: Horner additions and 171 compaction and densifying rounds
KZG_POINT_ADDS_2E20 = 297
#: run_scan and compact_add launches of the same prove: its compaction and
#: densifying rounds, one of each a round (the round count follows the data,
#: which is fixed by the seeds)
KZG_COMPACT_ROUNDS_2E20 = 171
#: the proofs of phases 3, 5 and 8 are made once more this many times, warm
WARM_RUNS = 3

#: the NTT path: BN254 Fr tables of 2^20 and 2^22 entries (bench.py:328-330);
#: fft_evaluate / fft_interpolate at the first size
NTT_LOG_SIZES = (20, 22)
#: ntt_phase1 against its plain version at these sizes (log2), each at every
#: tile it takes, and ntt_stage at these (log2 size, stages)
NTT_PHASE1_CHECK_LOGS = tuple(range(0, 23))
NTT_STAGE_CHECKS = tuple((log_n, tuple(range(1, log_n + 1))) for log_n in (12, 20, 22))
NTT_CPU_TIE_LOG = 12

#: phase 15: the oracle's fields, and whether every kernel of the phase runs on
#: each (BLS12-381 Fq, the 12-word field: mont_mul alone); tables of 2^12
ORACLE_FIELDS = ((BN254_FQ, True), (BN254_FR, True), (BLS12_381_FR, True), (BLS12_381_FQ, False))
ORACLE_LOG_SIZE = 12
#: Keccak-256 of ``serialize.encode_sumcheck_proof`` of the seed-0 2^20 BN254 Fq
#: proof, from the port's CPU path (scripts/proof_digest.py --blob); a test holds
#: the port's blob to the JAX package's, byte for byte, at 16 entries
SUMCHECK_BLOB_DIGEST_2E20 = "a4c4feb633415853b4457da88534ad8999f607ea1bea082a49f04ffa52588181"

#: phase 16: the batched NTT kernels against their plain versions, word for
#: word, at these (log2 entries of a table, tables in the batch): the row DFTs
#: of the four-step NTT at 2^20 and 2^22, three rows of 2^12, rows of 1, 2, 4
NTT_BATCH_CHECKS = ((10, 1 << 10), (11, 1 << 11), (12, 3), (0, 5), (1, 5), (2, 5))
#: the slots of the one-card mesh of phase 16 (the card repeated)
MESH_SLOTS = 4

KERNEL_SOURCE = "zktpu_torch/csrc/sumcheck_kernels.cu"
POINT_KERNEL_SOURCE = "zktpu_torch/csrc/point_kernels.cu"
NTT_KERNEL_SOURCE = "zktpu_torch/csrc/ntt_kernels.cu"
TRANSCRIPT_KERNEL_SOURCE = "zktpu_torch/csrc/transcript_kernels.cu"
MSM_KERNEL_SOURCE = "zktpu_torch/csrc/msm_kernels.cu"
GKR_PHASE_KERNEL_SOURCE = "zktpu_torch/csrc/gkr_phase_kernels.cu"
#: the kernel sources, one nvcc each, all started together
CUDA_STEMS = ("sumcheck_kernels", "point_kernels", "ntt_kernels", "transcript_kernels",
              "msm_kernels", "gkr_phase_kernels", "gkr_tables_kernels")
#: the TPU kernel each replaces; the transcript and MSM kernels replace zktpu's
#: device programs (XLA, not Pallas): keccak_f the permutation, round_step the
#: round of gkr/fused_lazy.py:_big_round and of sumcheck/fused.py:_device_prove
#: (:192); run_scan the scan of msm/pippenger.py:_compact_round and _max_run
#: (:295), compact_add the rest of that round (its gathers, point_add_px at :180
#: and its selects), horner the window combine _horner_multi; gkr_big_round a
#: fused GKR round (gkr/fused_lazy.py:_big_round), gkr_phase_tail the rest of a
#: phase (_scan_phase_fixed)
REPLACES = {
    "ntt_phase1": "zktpu/ntt/pallas_ntt.py:107",
    "ntt_stage": "zktpu/ntt/pallas_ntt.py:154",
    "point_add": "zktpu/curve/pallas_point.py:78",
    "point_double": "zktpu/curve/pallas_point.py:117",
    "mont_mul": "zktpu/field/pallas_kernels.py:110",
    "fold": "zktpu/field/pallas_kernels.py:140",
    "halves_sums": "zktpu/field/pallas_kernels.py:184",
    "fold_and_halves": "zktpu/field/pallas_kernels.py:227",
    "gkr_round": "zktpu/field/pallas_kernels.py:292",
    "keccak_f": "zktpu/hash/keccak_device.py:78",
    "round_step": "zktpu/gkr/fused_lazy.py:215",
    "run_scan": "zktpu/msm/pippenger.py:154",
    "compact_add": "zktpu/msm/pippenger.py:180",
    "horner": "zktpu/msm/pippenger.py:448",
    "gkr_big_round": "zktpu/gkr/fused_lazy.py:216",
    "gkr_phase_tail": "zktpu/gkr/fused_lazy.py:155",
}
#: launches the main path must make at 2^NUM_VARS. mont_mul: to_mont of the
#: table, and the verifier's to_mont of the point and from_mont of the
#: evaluation (a round's canonical sums and its challenge's Montgomery form are
#: round_step's work); then round 0, rounds 1..n-1, one round_step a round, the
#: verifier's n folds; the transcript's permutations run inside round_step
EXPECTED_LAUNCHES = {
    "mont_mul": 1 + 2,
    "halves_sums": 1,
    "fold_and_halves": NUM_VARS - 1,
    "fold": NUM_VARS,
    "gkr_round": 0,
    "round_step": NUM_VARS,
    "keccak_f": 0,
}


def phase_big_rounds(j: int) -> int:
    """The rounds of a fused GKR phase on tables of 2^j entries that sum a table
    above ``fused_lazy.TAIL_MAX`` entries (2^j, .., 2): a gkr_big_round each."""
    return sum(1 for k in range(1, j + 1) if 1 << k > fused_lazy.TAIL_MAX)


def gkr_big_rounds(n: int) -> int:
    """gkr_big_round launches of ``prove_layers`` on a halving circuit of 2^n
    inputs: the layer whose inputs have j variables runs two phases of 2^j."""
    return sum(2 * phase_big_rounds(j) for j in range(1, n + 1))


def gkr_expected_launches(n: int) -> dict[str, int]:
    """Launches of ``prove_layers`` (lazy, fused) + ``verify_layers`` (lazy) on a
    halving circuit of 2^n inputs. The layer whose inputs have j variables
    (j = 1..n) runs 2j rounds, j a phase.

    gkr_big_round: one a round whose table is above ``fused_lazy.TAIL_MAX``
    entries (20 at 2^16, 6 at 2^18, 42 at 2^14); gkr_phase_tail: one a phase, 2n; the
    rounds' sums,
    folds, canonical form, interpolation, absorb and challenge are theirs, so
    the walk's sumcheck rounds launch no gkr_round, round_step, fold, mont_mul
    or keccak_f.
    gkr_wiring: one a layer in the prover and one in the verifier, 2n;
    gkr_phase1_stack and gkr_phase2_stack: one a layer, n each (the layer's
    tables, ``gkr/tables.py``).
    fold: j for each of the layer's two input evaluations; one for the output
    polynomial's evaluation, in the prover and again in the verifier.
    mont_mul, prover: a layer makes 1 for the upload of its wiring scalars, 1
    for the upload of phase 1's challenges and 4 for the two evaluations: 6;
    the walk adds 1 for the inputs, n for the circuit, 3 for the output
    polynomial.
    mont_mul, verifier: a layer makes 1 for the upload of its wiring scalars,
    and in the wiring evaluation 4j + 1 for the two eq tables, 3 for the
    weights, 1 for the two sums: 4j + 6; the walk adds 2 for the output
    polynomial.
    """
    rounds = n * (n + 1)
    prover_mul = 6 * n + 1 + n + 3
    verifier_mul = 2 * rounds + 6 * n + 2
    return {
        "mont_mul": prover_mul + verifier_mul,
        "fold": rounds + 1 + 1,
        "gkr_round": 0,
        "halves_sums": 0,
        "fold_and_halves": 0,
        "round_step": 0,
        "keccak_f": 0,
        "gkr_big_round": gkr_big_rounds(n),
        "gkr_phase_tail": 2 * n,
        "gkr_wiring": 2 * n,
        "gkr_phase1_stack": n,
        "gkr_phase2_stack": n,
    }


def say(msg: str) -> None:
    print(msg, flush=True)


#: the ``check`` calls that ran; ``main`` prints the total
checks_run = 0


def check(cond, msg: str) -> None:
    global checks_run
    checks_run += 1
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def benchmark_values(num_vars: int) -> list[int]:
    """The benchmark table: 2^num_vars values below 2^62 from numpy seed 0."""
    rng = np.random.default_rng(0)
    return [int(v) for v in rng.integers(0, 1 << 62, size=1 << num_vars)]


def proof_digest(spec, proof) -> str:
    flat = [proof.claimed_sum] + [v for rp in proof.proof_polynomials for v in rp]
    return hk.keccak256(vec_to_bytes(spec, flat)).hex()


def _gkr_benchmark_draws(num_vars: int):
    rng = np.random.default_rng(7)
    structure = []
    n = 1 << (num_vars - 1)
    while n >= 1:
        structure.append([ADD if bit else MUL for bit in rng.integers(2, size=n)])
        n //= 2
    inputs = [int(v) for v in rng.integers(0, 1 << 61, size=1 << num_vars)]
    return rng, structure, inputs


def gkr_benchmark(num_vars: int):
    """A halving circuit of 2^num_vars inputs and 2^num_vars - 1 random add/mul
    gates, and inputs below 2^61, from numpy seed 7: (structure, inputs)."""
    return _gkr_benchmark_draws(num_vars)[1:]


def gkr_benchmark_taus(num_vars: int) -> list[int]:
    """The trusted setup's secrets of the benchmark's input proof: the next
    ``num_vars`` draws of the same generator, in [2, 2^60)."""
    rng = _gkr_benchmark_draws(num_vars)[0]
    return [int(t) for t in rng.integers(2, 1 << 60, size=num_vars)]


def kzg_proof_digest(input_proof) -> str:
    """Keccak-256 over the affine coordinates of the commitment and of every
    quotient point (r_b's, then r_c's), 48 little-endian bytes each; infinity
    counts as (0, 0)."""
    points = [input_proof.commitment] + input_proof.proof[0] + input_proof.proof[1]
    flat = []
    for pt in points:
        flat += [0, 0] if pt is None else [pt[0].n, pt[1].n]
    return hk.keccak256(vec_to_bytes(BLS12_381_FQ, flat)).hex()


def gkr_proof_values(layers_proof) -> list[int]:
    """Every integer of a ``LayersProof`` in a fixed order: the output table,
    each layer's round coefficients, the claimed evaluations, the point pair and
    the input layer's two evaluations."""
    proof = layers_proof.proof
    flat = list(proof.output_poly.to_ints())
    for layer in proof.proof_polynomials:
        for poly in layer:
            flat += poly.coefficients
    for o_1, o_2 in proof.claimed_evaluations:
        flat += [o_1, o_2]
    return flat + layers_proof.r_b + layers_proof.r_c + list(layers_proof.input_evals)


def same_layers_proof(a, b) -> bool:
    return gkr_proof_values(a) == gkr_proof_values(b)


def gkr_proof_digest(spec, layers_proof) -> str:
    return hk.keccak256(vec_to_bytes(spec, gkr_proof_values(layers_proof))).hex()


def template_args(mangled: str) -> list[str]:
    """The int, bool and enum arguments of a mangled template argument list:
    ``Li3ELb0ELN2ns4KindE1E`` -> ["3", "false", "1"]."""
    return [("false", "true")[int(v)] if kind == "b" else v
            for kind, v in re.findall(r"L(i|b|N[^E]*E)(\d+)E", mangled)]


def resource_usage(log: str, needle: str) -> list[str]:
    """What ``nvcc --resource-usage`` printed for the kernels whose mangled name
    holds ``needle``: the template's arguments where it has them (``<W=8>`` for
    the summing kernels' word count; a lone bool as itself), then ptxas's own
    two lines."""
    lines = log.splitlines()
    out = []
    for i, line in enumerate(lines):
        if "Function properties for" in line and needle in line:
            label = needle
            if needle + "I" in line:
                args = template_args(line.split(needle + "I", 1)[1].split("EE", 1)[0] + "E")
                label += (f"<W={args[0]}>" if len(args) == 1 and args[0].isdigit()
                          else "<" + ", ".join(args) + ">")
            out.append(f"{label}: {lines[i + 1].strip()}; "
                       f"{lines[i + 2].split(':', 1)[1].strip()}")
    return out


def gpu_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return res.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------------
# inputs
# ----------------------------------------------------------------------

def raw_words(ctx, value: int) -> np.ndarray:
    """Words of ``value`` as it is (not reduced mod p)."""
    return np.frombuffer(value.to_bytes(4 * ctx.num_words, "little"), dtype="<u4")


def random_table(ctx, rng, *shape, edges=()):
    """Random field elements below p as an int32 (*shape, W) tensor on the card;
    the first rows of the flattened table are overwritten by ``edges`` (ints)."""
    w = ctx.num_words
    words = rng.integers(0, 1 << 32, size=(*shape, w), dtype=np.uint32)
    # a top word strictly below the modulus's top word keeps the value below p
    words[..., w - 1] = rng.integers(0, ctx.p_words_host[-1], size=shape, dtype=np.uint32)
    flat = words.reshape(-1, w)
    for i, v in enumerate(edges[: flat.shape[0]]):
        flat[i] = raw_words(ctx, v)
    return ctx.to_device(words)


def max_abs_err(a, b) -> int:
    if a.shape != b.shape:
        return -1
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


# ----------------------------------------------------------------------
# phase 2: every kernel against its plain version
# ----------------------------------------------------------------------

def compare_kernels(ctx, rng, size: int) -> dict[str, int]:
    """Run the five kernels and their plain versions on the same inputs at one
    size; returns the largest absolute word difference per kernel."""
    p = ctx.spec.modulus
    top = (1 << (32 * ctx.num_words)) - 1
    errs = {}

    a = random_table(ctx, rng, size, edges=(top, p - 1, 0, 1, p))
    b = random_table(ctx, rng, size, edges=(p - 1, p - 1, p - 1, 0, 1))
    errs["mont_mul"] = max(
        max_abs_err(fk.mont_mul(ctx, a, b), fk.mont_mul_plain(ctx, a, b)),
        # table x one element, as to_mont of a raw table uses it
        max_abs_err(fk.mont_mul(ctx, a, ctx.r2), fk.mont_mul_plain(ctx, a, ctx.r2)),
    )

    table = random_table(ctx, rng, size, edges=(p - 1, 0, 1, p - 1))
    r = random_table(ctx, rng, edges=(p - 1,) if size == 4 else ())
    stack = random_table(ctx, rng, 2, 2, size, edges=(0, p - 1))
    errs["fold"] = max(
        max_abs_err(fk.fold(ctx, table, r), fk.fold_plain(ctx, table, r)),
        max_abs_err(fk.fold(ctx, stack, r), fk.fold_plain(ctx, stack, r)),
    )

    errs["halves_sums"] = max_abs_err(
        fk.halves_sums(ctx, table), fk.halves_sums_plain(ctx, table)
    )

    folded, rows = fk.fold_and_halves(ctx, table, r)
    folded_ref, rows_ref = fk.fold_and_halves_plain(ctx, table, r)
    errs["fold_and_halves"] = max(max_abs_err(folded, folded_ref), max_abs_err(rows, rows_ref))

    # b - a borrows and b + (b - a) crosses p where p - 1 meets 0 and 1; then the
    # shape of the fused prover's first phase: an all-zero table and a table of ones
    stack = random_table(ctx, rng, 2, 2, size, edges=(0, 1, p - 1, p - 1, 0, 1))
    phase1 = stack.clone()
    phase1[1, 0] = 0
    phase1[1, 1] = ctx.one_mont
    errs["gkr_round"] = max(
        max_abs_err(fk.gkr_round(ctx, stack), fk.gkr_round_plain(ctx, stack)),
        max_abs_err(fk.gkr_round(ctx, phase1), fk.gkr_round_plain(ctx, phase1)),
        max_abs_err(fk.gkr_round(ctx, torch.zeros_like(stack)),
                    torch.zeros((3, ctx.num_words + fk.EXTRA_WORDS), dtype=torch.int32,
                                device=ctx.device)),
    )
    torch.cuda.synchronize()
    return errs


def phase_kernels_vs_plain() -> dict[str, int]:
    worst = {name: 0 for name in fk.KERNEL_NAMES}
    # the 12-word build (BLS12-381 Fq) is held at the small sizes only
    for spec, sizes in ((BN254_FQ, CHECK_SIZES), (BLS12_381_FR, CHECK_SIZES),
                        (BLS12_381_FQ, CHECK_SIZES[:4])):
        ctx = fb.get_ctx(spec)
        rng = np.random.default_rng(1)
        for size in sizes:
            errs = compare_kernels(ctx, rng, size)
            say(f"  {spec.name} size {size}: " + " ".join(f"{k}={v}" for k, v in errs.items()))
            for name, err in errs.items():
                check(err == 0, f"{name} differs from its plain version ({spec.name}, size {size})")
                worst[name] = max(worst[name], err)
        if spec.num_words == 8:
            # every entry p - 1: the column sums of the three rows at their largest
            size = CHECK_SIZES[-1]
            stack = ctx.to_device(np.broadcast_to(
                raw_words(ctx, spec.modulus - 1), (2, 2, size, ctx.num_words)).copy())
            err = max_abs_err(fk.gkr_round(ctx, stack), fk.gkr_round_plain(ctx, stack))
            say(f"  {spec.name} size {size}, every entry p - 1: gkr_round={err}")
            check(err == 0, f"gkr_round differs from its plain version on p - 1 ({spec.name})")
    return worst


def phase_sum_kernels_vs_plain() -> dict[str, int]:
    """halves_sums and fold_and_halves, the one-launch kernels, at every size,
    on their edge cases and back to back."""
    worst = {"halves_sums": 0, "fold_and_halves": 0}

    def hold(name: str, got, want, what: str) -> None:
        err = max(max_abs_err(g, v) for g, v in zip(got, want))
        check(err == 0, f"{name} differs from its plain version ({what})")
        worst[name] = max(worst[name], err)

    for spec, top_log in SUM_CHECK_LOGS:
        ctx = fb.get_ctx(spec)
        w = ctx.num_words
        p = spec.modulus
        rng = np.random.default_rng(3)
        challenges = [ctx.to_device(raw_words(ctx, v).copy())
                      for v in (0, 1, p - 1, spec.R % p)]
        for log_size in range(1, top_log + 1):
            size = 1 << log_size
            what = f"{spec.name}, size {size}"
            table = random_table(ctx, rng, size, edges=(p - 1, 0, 1, p - 1))
            raw = ctx.to_device(rng.integers(0, 1 << 32, size=(size, w), dtype=np.uint32))
            for t in (table, raw):
                hold("halves_sums", [fk.halves_sums(ctx, t)], [fk.halves_sums_plain(ctx, t)], what)
            for r in challenges + [random_table(ctx, rng)]:
                hold("fold_and_halves", fk.fold_and_halves(ctx, table, r),
                     fk.fold_and_halves_plain(ctx, table, r), what)
        for log_size in ALL_ONES_LOGS if w == 8 else (top_log,):
            ones = torch.full((1 << log_size, w), -1, dtype=torch.int32, device=ctx.device)
            hold("halves_sums", [fk.halves_sums(ctx, ones)], [fk.halves_sums_plain(ctx, ones)],
                 f"{spec.name}, every word 0xFFFFFFFF, size 2^{log_size}")
            del ones
        for log_size in TICKET_LOGS if top_log >= TICKET_LOGS[-1] else ():
            table = random_table(ctx, rng, 1 << log_size)
            r = random_table(ctx, rng)
            want_h = [fk.halves_sums_plain(ctx, table)]
            want_f = fk.fold_and_halves_plain(ctx, table, r)
            for blocks in (None, TICKET_BLOCKS, 0):
                what = (f"{spec.name}, size 2^{log_size}, "
                        f"{'own' if blocks is None else blocks} blocks a row, twice")
                twice_h = [fk._launch_halves_sums(ctx, table, blocks) for _ in range(2)]
                twice_f = [fk._launch_fold_and_halves(ctx, table, r, blocks) for _ in range(2)]
                for got in twice_h:
                    hold("halves_sums", [got], want_h, what)
                for got in twice_f:
                    hold("fold_and_halves", got, want_f, what)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        say(f"  {spec.name}: halves_sums and fold_and_halves at every size 2..2^{top_log}, "
            f"r = 0, 1, p - 1, R mod p and random, all-ones tables"
            + (", twice back to back on three grids" if top_log >= TICKET_LOGS[-1] else "")
            + ": " + " ".join(f"{k}={v}" for k, v in worst.items()))
    return worst


# ----------------------------------------------------------------------
# phases 3 and 4: the main path and its tie to the reference
# ----------------------------------------------------------------------

def phase_main_path(ctx):
    values = benchmark_values(NUM_VARS)
    torch.cuda.synchronize()
    fk.reset_launches()
    tk.reset_launches()
    poly = MultilinearPoly.from_ints(ctx, values)
    proof = fused.prove(poly)
    ok = protocol.verify(poly, proof)
    launches = {**fk.launches, **tk.launches}
    say(f"  launches on the main path: {launches}")
    check(ok, "verify refused the fused prover's proof")
    check(len(proof.proof_polynomials) == NUM_VARS, "wrong number of round polynomials")
    p = ctx.spec.modulus
    check(all(0 <= v < p for rp in proof.proof_polynomials for v in rp), "values not canonical")
    check(proof.claimed_sum == sum(values) % p, "claimed sum is not the table's sum")
    check(launches == EXPECTED_LAUNCHES, f"launch counts {launches} != {EXPECTED_LAUNCHES}")
    for _ in range(WARM_RUNS):
        again = fused.prove(poly)
        check(protocol.verify(poly, again) and again == proof,
              "a warm proof is refused or differs from the first")
    say(f"  {WARM_RUNS} warm proofs == the first, each accepted")
    return poly, proof, launches


def phase_reference_tie(ctx, poly, proof) -> None:
    host_loop = protocol.prove(poly)
    check(host_loop.claimed_sum == proof.claimed_sum
          and host_loop.proof_polynomials == proof.proof_polynomials,
          "fused proof differs from the host-loop prover's")
    say("  fused proof == host-loop proof on the card")

    tampered = protocol.Proof([list(rp) for rp in proof.proof_polynomials], proof.claimed_sum)
    tampered.proof_polynomials[3][1] = (tampered.proof_polynomials[3][1] + 1) % ctx.spec.modulus
    check(not protocol.verify(poly, tampered), "a tampered proof was accepted")
    say("  tampered proof refused")

    digest = proof_digest(ctx.spec, proof)
    say(f"  proof digest {digest}")
    check(digest == PROOF_DIGEST_2E20, f"proof digest differs from the stored {PROOF_DIGEST_2E20}")

    small = benchmark_values(12)
    on_card = fused.prove(MultilinearPoly.from_ints(ctx, small))
    cpu_ctx = fb.get_ctx(ctx.spec, device="cpu")
    on_cpu = fused.prove(MultilinearPoly.from_ints(cpu_ctx, small))
    check(on_card.claimed_sum == on_cpu.claimed_sum
          and on_card.proof_polynomials == on_cpu.proof_polynomials,
          "2^12 proof on the card differs from the CPU's")
    say("  2^12 proof on the card == 2^12 proof on the CPU")


# ----------------------------------------------------------------------
# phases 5 and 6: the GKR layer walk and its ties
# ----------------------------------------------------------------------

def phase_gkr_main_path(ctx):
    n = GKR_NUM_VARS
    structure, inputs = gkr_benchmark(n)
    circuit = Circuit(ctx, structure)
    input_poly = MultilinearPoly.from_ints(ctx, inputs)
    evaluations = circuit.evaluate(input_poly)
    check(len(evaluations) == n and evaluations[-1].table.shape[0] == 1, "circuit evaluation shape")

    fk.reset_launches()
    tk.reset_launches()
    gk.reset_launches()
    gt.reset_launches()
    proved = gkr.prove_layers(circuit, inputs)
    verdict = gkr.verify_layers(proved.proof, circuit, proved.input_evals)
    launches = {**fk.launches, **tk.launches, **gk.launches, **gt.launches}
    say(f"  launches on the GKR path: {launches}")

    check(verdict.verified, "verify_layers refused the prover's proof")
    check((verdict.r_b, verdict.r_c) == (proved.r_b, proved.r_c), "verifier's point pair differs")
    expected = gkr_expected_launches(n)
    check(launches == expected, f"launch counts {launches} != {expected}")
    proof = proved.proof
    check([len(layer) for layer in proof.proof_polynomials] == [2 * j for j in range(1, n + 1)],
          "wrong number of round polynomials")
    p = ctx.spec.modulus
    check(all(0 <= c < p and len(poly.coefficients) <= 3
              for layer in proof.proof_polynomials for poly in layer for c in poly.coefficients),
          "round coefficients not canonical")
    check(proof.output_poly.to_ints() == [evaluations[-1].to_ints()[0], 0], "output table")
    check(proved.input_evals == (input_poly.evaluate_int(proved.r_b),
                                 input_poly.evaluate_int(proved.r_c)),
          "the input evaluations are not the input polynomial's at r_b, r_c")
    say("  proof verifies; o_1, o_2 == input_poly(r_b), input_poly(r_c)")

    bad = copy.deepcopy(proof)
    o_1, o_2 = bad.claimed_evaluations[n // 2]
    bad.claimed_evaluations[n // 2] = ((o_1 + 1) % p, o_2)
    check(not gkr.verify_layers(bad, circuit, proved.input_evals).verified,
          "a tampered claimed evaluation was accepted")
    bad = copy.deepcopy(proof)
    coeffs = bad.proof_polynomials[n - 1][3].coefficients
    coeffs[0] = (coeffs[0] + 1) % p
    check(not gkr.verify_layers(bad, circuit, proved.input_evals).verified,
          "a tampered round coefficient was accepted")
    check(not gkr.verify_layers(proof, circuit, ((proved.input_evals[0] + 1) % p,
                                                 proved.input_evals[1])).verified,
          "a wrong input evaluation was accepted")
    say("  tampered claimed evaluation, round coefficient and input evaluation refused")
    for _ in range(WARM_RUNS):
        again = gkr.prove_layers(circuit, inputs)
        check(gkr.verify_layers(again.proof, circuit, again.input_evals).verified,
              "warm verify failed")
    check(same_layers_proof(again, proved), "a warm proof differs from the first")
    say(f"  {WARM_RUNS} warm proofs accepted, the last == the first")
    return circuit, inputs, proved, launches


def phase_gkr_ties(ctx) -> None:
    structure, small_inputs = gkr_benchmark(8)
    small = Circuit(ctx, structure)
    launched = fk.launches["gkr_round"]
    dense = gkr.prove_layers(small, small_inputs, lazy=False)
    check(fk.launches["gkr_round"] - launched == 8 * 9, "the dense prover did not take the kernel")
    check(same_layers_proof(dense, gkr.prove_layers(small, small_inputs)),
          "2^8 dense proof differs from the lazy one")
    for lazy in (True, False):
        check(gkr.verify_layers(dense.proof, small, dense.input_evals, lazy=lazy).verified,
              f"verify_layers(lazy={lazy}) refused the 2^8 dense proof")
    say("  2^8 inputs: dense proof == lazy proof, accepted by the lazy and the dense verifier")

    structure, mid_inputs = gkr_benchmark(10)
    on_card = gkr.prove_layers(Circuit(ctx, structure), mid_inputs)
    cpu_ctx = fb.get_ctx(ctx.spec, device="cpu")
    on_cpu = gkr.prove_layers(Circuit(cpu_ctx, structure), mid_inputs)
    check(same_layers_proof(on_card, on_cpu), "2^10 proof on the card differs from the CPU's")
    say("  2^10 proof on the card == 2^10 proof on the CPU")

    structure, digest_inputs = gkr_benchmark(GKR_DIGEST_INPUTS)
    digest = gkr_proof_digest(
        ctx.spec, gkr.prove_layers(Circuit(ctx, structure), digest_inputs))
    say(f"  2^{GKR_DIGEST_INPUTS} proof digest {digest}")
    check(digest == GKR_PROOF_DIGEST_2E16,
          f"GKR proof digest differs from the stored {GKR_PROOF_DIGEST_2E16}")


# ----------------------------------------------------------------------
# before phase 14: the device kernels of a prove and of a GKR phase
# ----------------------------------------------------------------------

def count_device_kernels(fn) -> int:
    """Device kernels launched by ``fn``, from a torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.device_time_total > 0)


def phase_device_kernels(ctx, gctx) -> None:
    """The device kernels of phase 3's warm 2^20 sumcheck prove and of fused
    GKR phases, by the profiler: at most 3 a round + 10 for the prove; for a
    GKR phase of 2^10 entries one (its gkr_phase_tail), of 2^20 entries one a
    round above ``fused_lazy.TAIL_MAX`` and a tail. Runs last: once the
    profiler has been on, every later launch in the process costs the host
    more."""
    poly = MultilinearPoly.from_ints(ctx, benchmark_values(NUM_VARS))
    fused.prove(poly)
    before = tk.launches["round_step"]
    kernels = count_device_kernels(lambda: fused.prove(poly))
    check(tk.launches["round_step"] - before == NUM_VARS, "a prove is not a round_step a round")
    say(f"  one fused 2^{NUM_VARS} sumcheck prove (phase 3's): {kernels} device kernels")
    check(kernels <= 3 * NUM_VARS + 10, f"{kernels} device kernels in a prove")
    del poly

    rng = np.random.default_rng(3)
    transcript = Transcript(gctx.spec)
    transcript.append_field_elements([1, 2])
    pairs, tail = transcript.sponge().state_lanes()
    consts = fused_lazy._PhaseConsts(gctx, kd.pairs_to_lanes(pairs), kd.bytes_to_lanes(tail))
    for log_size in (10, GKR_NUM_VARS):
        tables = random_table(gctx, rng, 2, 2, 1 << log_size)
        fused_lazy._device_phase(gctx, tables, consts)
        gk.reset_launches()
        kernels = count_device_kernels(lambda: fused_lazy._device_phase(gctx, tables, consts))
        want = {"gkr_big_round": phase_big_rounds(log_size), "gkr_phase_tail": 1}
        say(f"  one fused GKR phase of {log_size} rounds: {kernels} device kernels, launches "
            f"{gk.launches}")
        check(gk.launches == want and kernels == sum(want.values()),
              f"a GKR phase of 2^{log_size} entries: {kernels} device kernels for {gk.launches}")


# ----------------------------------------------------------------------
# the G1 point kernels: inputs and comparison
# ----------------------------------------------------------------------

def random_scalars(rng, n: int, device):
    """n random 254-bit scalars as canonical (n, 8) int32 words on the card."""
    words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint32)
    words[:, 7] &= 0x3FFFFFFF
    return fb.words_to_tensor(words, device)


def random_points(rng, n: int, device):
    """n random G1 points with Z != 1: comb multiples of G1, each re-scaled to
    (X l^2, Y l^3, Z l) by a random l, which is the same point."""
    fq = fb.get_ctx(BLS12_381_FQ, device)
    X, Y, Z = generator_comb_mul(random_scalars(rng, n, device))
    return rescale_points(fq, (X, Y, Z), random_table(fq, rng, n))


def rescale_points(fq, pt, lam):
    X, Y, Z = pt
    lam2 = fk.mont_mul(fq, lam, lam)
    return (fk.mont_mul(fq, X, lam2), fk.mont_mul(fq, Y, fk.mont_mul(fq, lam2, lam)),
            fk.mont_mul(fq, Z, lam))


def point_edge_lanes(fq, rng, p1, p2):
    """Overwrite the first lanes of two batches with the edge cases, as far as
    the width goes: P == Q in the same and in another Jacobian form, P == -Q,
    each operand infinite, both infinite, coordinates 0, 1 and p - 1."""
    n = p1[0].shape[0]
    p = fq.spec.modulus
    p1 = tuple(t.clone() for t in p1)
    p2 = tuple(t.clone() for t in p2)
    other_form = rescale_points(fq, p1, random_table(fq, rng, n))
    neg_y = fb.sub(fq, torch.zeros_like(p1[1]), p1[1])
    # three rows of raw coordinates: (0, p - 1, p - 1), (0, 1, p - 1), (1, 1, 1)
    raw = tuple(random_table(fq, rng, 3, edges=col)
                for col in ((0, 0, 1), (p - 1, 1, 1), (p - 1, p - 1, 1)))

    zero = torch.zeros_like(p1[2][0])
    row = lambda pt, i: tuple(t[i].clone() for t in pt)  # noqa: E731
    cases = [  # lane -> (left, right) replacements, built only where the lane exists
        lambda: (None, row(other_form, 0)),                                  # P == Q, other form
        lambda: (None, (p1[0][1], neg_y[1], p1[2][1])),                      # P == -Q
        lambda: (None, row(p1, 2)),                                          # P == Q, same words
        lambda: ((p1[0][3], p1[1][3], zero), None),                          # left infinite
        lambda: (None, (p2[0][4], p2[1][4], zero)),                          # right infinite
        lambda: ((p1[0][5], p1[1][5], zero), (p2[0][5], p2[1][5], zero)),    # both infinite
        lambda: (row(raw, 0), None),                                         # coordinates 0, p - 1
        lambda: (row(raw, 1), row(raw, 0)),
        lambda: (row(raw, 2), row(raw, 1)),                                  # and 1
    ]
    for lane, build in enumerate(cases[:n]):
        left, right = build()
        for k in range(3):
            if left is not None:
                p1[k][lane] = left[k]
            if right is not None:
                p2[k][lane] = right[k]
    return p1, p2


def triple_err(a, b) -> int:
    return max(max_abs_err(x, y) for x, y in zip(a, b))


def phase_point_kernels_vs_plain() -> dict[str, int]:
    fq = fb.get_ctx(BLS12_381_FQ)
    rng = np.random.default_rng(4)
    worst = {name: 0 for name in pk.KERNEL_NAMES}
    for n in POINT_CHECK_WIDTHS:
        p1, p2 = point_edge_lanes(fq, rng, random_points(rng, n, fq.device),
                                  random_points(rng, n, fq.device))
        counts = POINT_DOUBLE_TIMES if n <= 4096 else (1,)
        errs = {
            "point_add": triple_err(pk.point_add(fq, p1, p2), pk.point_add_plain(fq, p1, p2)),
            "point_double": max(triple_err(pk.point_double(fq, p1, times),
                                           pk.point_double_plain(fq, p1, times))
                                for times in counts),
        }
        torch.cuda.synchronize()
        if n >= 8:
            # the edge lanes mean what they should: as affine points
            got = dc.unpack_points(tuple(t[:6].contiguous() for t in pk.point_add(fq, p1, p2)))
            a = dc.unpack_points(tuple(t[:6].contiguous() for t in p1))
            b = dc.unpack_points(tuple(t[:6].contiguous() for t in p2))
            check(got == [hc.add(x, y) for x, y in zip(a, b)], "edge lanes are not the group law")
            check(got[1] is None and got[5] is None and got[0] == hc.double(a[0]),
                  "edge lanes did not meet their cases")
        say(f"  bls12_381_fq width {n}: " + " ".join(f"{k}={v}" for k, v in errs.items())
            + f" (point_double times {counts})")
        for name, err in errs.items():
            check(err == 0, f"{name} differs from its plain version (width {n})")
            worst[name] = max(worst[name], err)
    return worst


# ----------------------------------------------------------------------
# phases 8 and 9: the whole GKR proof with its KZG input proof
# ----------------------------------------------------------------------

def reset_all_launches() -> None:
    fk.reset_launches()
    pk.reset_launches()
    nk.reset_launches()
    tk.reset_launches()
    mk.reset_launches()
    gk.reset_launches()
    gt.reset_launches()


def all_launches() -> dict[str, int]:
    return {**fk.launches, **pk.launches, **nk.launches, **tk.launches, **mk.launches,
            **gk.launches, **gt.launches}


def quotient_windows(n: int) -> list[int]:
    """The window width c of each quotient step of a 2^n-input proof: step k is
    one batched MSM of two segments over 2^(n-1-k) points."""
    return [pp.pick_window_bits_multi(2, 1 << (n - 1 - k)) for k in range(n)]


def kzg_expected_msm_launches(n: int) -> dict[str, int]:
    """The point kernels' and horner's launches of ``prove`` at 2^n inputs.
    Its Pippenger calls: the commitment, one call over 2^n points, then step k
    of the two openings, one batched call of two segments over 2^(n-1-k), each
    at its window c. point_add: the comb's COMB_W - 1 additions, the basis
    chain's n folds, and in each call the bucket reduction's Kogge-Stone and
    pair steps over 2^(c-1) buckets, c - 1 of each (the compaction and
    densifying rounds are compact_add's, the Horner chains horner's). horner:
    one for the commitment and one for every quotient step's chains together
    (21 before the quotient steps shared a launch). point_double: none (the
    comb's table is built before the path is driven)."""
    windows = [pp.pick_window_bits(1 << n)] + quotient_windows(n)
    return {"point_add": fixed_base.COMB_W - 1 + n + sum(2 * (c - 1) for c in windows),
            "point_double": 0, "horner": 2}


def tampered(whole, **changes):
    """A shallow copy of a GkrProof whose input proof has ``changes`` applied."""
    bad = copy.copy(whole)
    bad.input_proof = copy.copy(whole.input_proof)
    for name, value in changes.items():
        setattr(bad.input_proof, name, value)
    return bad


def phase_kzg_main_path(ctx, circuit, inputs, layers_launches):
    n = GKR_NUM_VARS
    taus = gkr_benchmark_taus(n)
    fixed_base._comb_table(ctx.device)  # the one-time table, as a running prover holds it
    reset_all_launches()
    proof = gkr.prove(circuit, inputs, taus=taus)
    prove_launches = all_launches()
    ok = gkr.verify(proof, circuit)
    launches = all_launches()
    say(f"  launches on the KZG path: {launches}")
    check(ok, "verify refused the prover's proof")

    kzg = proof.input_proof
    check(len(kzg.proof[0]) == len(kzg.proof[1]) == n, "wrong number of quotient points")
    check(all(hc.is_on_curve(pt, hc.B1) for pt in [kzg.commitment] + kzg.proof[0] + kzg.proof[1]),
          "a proof point is not on the curve")
    want = kzg_expected_msm_launches(n)
    got = {name: prove_launches[name] for name in want}
    check(got == want and launches["point_double"] == 0,
          f"point kernel and horner launches {got} != {want}")
    check(want["point_add"] == KZG_POINT_ADDS_2E20,
          f"point_add launches {want['point_add']} != {KZG_POINT_ADDS_2E20}")
    # every compaction round is one run_scan and one compact_add; each of the
    # 1 + n Pippenger calls takes at least one and its densifying round
    check(prove_launches["run_scan"] == prove_launches["compact_add"] == KZG_COMPACT_ROUNDS_2E20
          >= 2 * (1 + n), f"run_scan and compact_add launches {prove_launches['run_scan']}, "
          f"{prove_launches['compact_add']} != {KZG_COMPACT_ROUNDS_2E20}")
    walk = gkr_expected_launches(n)
    check(all(launches[name] >= walk[name] for name in walk),
          "the full proof launched the layer walk's kernels less often than the walk alone")
    for name in ("gkr_round", "round_step") + gk.KERNEL_NAMES + gt.KERNEL_NAMES:
        check(launches[name] == walk[name] == layers_launches[name],
              f"{name} launches differ from the layer walk's")

    p = ctx.spec.modulus
    bad_point = hc.add(kzg.proof[0][n // 2], hc.G1_GEN)
    quotients = list(kzg.proof[0])
    quotients[n // 2] = bad_point
    check(not gkr.verify(tampered(proof, proof=[quotients, kzg.proof[1]]), circuit),
          "a tampered quotient point was accepted")
    check(not gkr.verify(tampered(proof, commitment=hc.add(kzg.commitment, hc.G1_GEN)), circuit),
          "a tampered commitment was accepted")
    check(not gkr.verify(
        tampered(proof, opened_evals=[(kzg.opened_evals[0] + 1) % p, kzg.opened_evals[1]]), circuit),
        "a tampered opened evaluation was accepted")
    say("  tampered quotient point, commitment and opened evaluation refused (the first two "
        "by the host's pairings)")
    for _ in range(WARM_RUNS):
        again = gkr.prove(circuit, inputs, taus=taus)
    check(same_input_proof(again.input_proof, kzg), "a warm proof differs from the first")
    walked = gkr.verify_layers(again, circuit, tuple(again.input_proof.opened_evals))
    kp = again.input_proof
    check(KZG.verify(kp.commitment, kp.opened_evals[0], kp.proof[0], walked.r_b,
                     kp.kzg_setup.g2_taus), "KZG.verify refused the opening at r_b")
    say(f"  {WARM_RUNS} warm proofs; the last input proof == the first, its opening at r_b "
        "accepted by KZG.verify")
    return proof, taus, launches


def eq_at(taus: list[int], index: int) -> int:
    """eq_x(taus) at the MSB-first vertex ``index``."""
    p = BLS12_381_FR.modulus
    out = 1
    for k, tau in enumerate(taus):
        bit = (index >> (len(taus) - 1 - k)) & 1
        out = out * (tau if bit else 1 - tau) % p
    return out


def same_input_proof(a, b) -> bool:
    return (a.commitment == b.commitment and a.proof == b.proof
            and list(a.opened_evals) == list(b.opened_evals))


def phase_kzg_ties(ctx, inputs, proof, taus, layers_proved) -> None:
    n = GKR_NUM_VARS
    kzg = proof.input_proof
    check(gkr_proof_values(gkr.LayersProof(proof, layers_proved.r_b, layers_proved.r_c,
                                           tuple(kzg.opened_evals)))
          == gkr_proof_values(layers_proved), "the full proof's layer walk differs from prove_layers'")
    say("  layer walk of prove == prove_layers; opened evaluations == its input evaluations")

    input_poly = MultilinearPoly.from_ints(ctx, inputs)
    check(kzg.commitment == hc.multiply(hc.G1_GEN, input_poly.evaluate_int(taus)),
          "the commitment is not input_poly(taus) * G1")
    for side, point in ((0, layers_proved.r_b), (1, layers_proved.r_c)):
        quotients = kzg.kzg_setup._quotients(kzg.opened_evals[side], point, input_poly)
        for k, q in enumerate(quotients):
            q_at_tau = MultilinearPoly(ctx, fk.to_mont(ctx, q)).evaluate_int(taus[k + 1:])
            want = hc.multiply(hc.G1_GEN, q_at_tau) if q_at_tau else None
            check(kzg.proof[side][k] == want, f"quotient {k} of opening {side} is not q_k(taus) * G1")
    say(f"  commitment == input_poly(taus) * G1; all {2 * n} quotient commitments == "
        f"q_k(tau_k+1..) * G1 by the host's scalar multiplication")

    rows = sorted({0, 1, 12345 % (1 << n), (1 << n) // 3, (1 << n) - 1})
    idx = torch.tensor(rows, device=ctx.device)
    entries = dc.unpack_points(dc.gather_pt(kzg.kzg_setup.g1_lagrange_basis, idx))
    check(entries == [hc.multiply(hc.G1_GEN, eq_at(taus, i)) for i in rows],
          "an SRS entry is not eq_i(taus) * G1")
    say(f"  SRS entries {rows} == eq_i(taus) * G1")

    rng = np.random.default_rng(8)
    lanes = MSM_TIE_LANES
    scalars = random_scalars(rng, lanes, ctx.device)
    before = dict(pk.launches)
    comb = generator_comb_mul(scalars)
    check(pk.launches["point_add"] - before["point_add"] == fixed_base.COMB_W - 1
          and pk.launches["point_double"] == before["point_double"], "the comb's launch counts")
    before = dict(pk.launches)
    ladder = dc.batch_generator_mul(scalars)
    check(pk.launches["point_double"] - before["point_double"] == 255
          and pk.launches["point_add"] - before["point_add"] == 255, "the ladder's launch counts")
    check(dc.unpack_points(comb) == dc.unpack_points(ladder), f"comb != ladder at {lanes} lanes")
    say(f"  comb == ladder at {lanes} lanes; the comb made {fixed_base.COMB_W - 1} additions "
        "and no doubling, the ladder 255 of each")
    weights = random_scalars(rng, lanes, ctx.device)
    bitsplit = dc.unpack_points(tuple(t[None] for t in msm_bitsplit(comb, weights)))
    for c in MSM_TIE_WINDOWS:
        before = all_launches()
        got = pp.msm_pippenger(comb, weights, c)
        after = all_launches()
        check(after["horner"] - before["horner"] == 1
              and after["point_double"] == before["point_double"],
              f"the window combine at c={c} is not one horner launch")
        check(dc.unpack_points(tuple(t[None] for t in got)) == bitsplit,
              f"Pippenger (c={c}) != bit-split at {lanes} points")
    say(f"  Pippenger (c in {MSM_TIE_WINDOWS}) == bit-split MSM at {lanes} points; "
        "one horner launch and no point_double a call")

    structure, digest_inputs = gkr_benchmark(KZG_DIGEST_INPUTS)
    small = gkr.prove(Circuit(ctx, structure), digest_inputs,
                      taus=gkr_benchmark_taus(KZG_DIGEST_INPUTS))
    digest = kzg_proof_digest(small.input_proof)
    say(f"  2^{KZG_DIGEST_INPUTS} input proof digest {digest}")
    check(digest == KZG_PROOF_DIGEST_2E5,
          f"input proof digest differs from the stored {KZG_PROOF_DIGEST_2E5}")

    structure, tie_inputs = gkr_benchmark(KZG_CPU_TIE_INPUTS)
    tie_taus = gkr_benchmark_taus(KZG_CPU_TIE_INPUTS)
    on_card = gkr.prove(Circuit(ctx, structure), tie_inputs, taus=tie_taus)
    cpu_ctx = fb.get_ctx(ctx.spec, device="cpu")
    on_cpu = gkr.prove(Circuit(cpu_ctx, structure), tie_inputs, taus=tie_taus)
    check(same_input_proof(on_card.input_proof, on_cpu.input_proof),
          f"2^{KZG_CPU_TIE_INPUTS} input proof on the card differs from the CPU's")
    say(f"  2^{KZG_CPU_TIE_INPUTS} input proof on the card == on the CPU")


# ----------------------------------------------------------------------
# phases 11 and 12: the NTT
# ----------------------------------------------------------------------

def phase_ntt_kernels_vs_plain() -> dict[str, int]:
    ctx = fb.get_ctx(BN254_FR)
    cpu = fb.get_ctx(BN254_FR, device="cpu")
    rng = np.random.default_rng(9)
    p = ctx.spec.modulus
    edges = (0, 1, p - 1, ctx.spec.R % p)
    worst = {name: 0 for name in nk.KERNEL_NAMES}

    def note(name, err, what):
        check(err == 0, f"{name} differs from its plain version ({what})")
        worst[name] = max(worst[name], err)

    for inverse in (False, True):
        # uncached builds: the main path below must build its own tables
        tws = {log_n: nk.build_twiddles(ctx, log_n, inverse)
               for log_n in set(NTT_PHASE1_CHECK_LOGS) | {log_n for log_n, _ in NTT_STAGE_CHECKS}}
        check(torch.equal(tws[NTT_CPU_TIE_LOG].cpu(), nk.build_twiddles(cpu, NTT_CPU_TIE_LOG, inverse)),
              "the card's twiddle table differs from the CPU's")
        errs = []
        for log_n in NTT_PHASE1_CHECK_LOGS:
            x = random_table(ctx, rng, 1 << log_n, edges=edges)
            # the plain version at tile 2^k is the one at 2^(k-1) and one more plain stage
            plain = nk.ntt_phase1_plain(ctx, x, tws[log_n], 0)
            group = 0
            for log_tile in range(min(nk.LOG_TILE, log_n) + 1):
                if log_tile:
                    plain = nk.ntt_stage_plain(ctx, plain, tws[log_n], log_tile)
                err = max_abs_err(nk.ntt_phase1(ctx, x, tws[log_n], log_tile), plain)
                note("ntt_phase1", err, f"2^{log_n}, tile 2^{log_tile}, inverse={inverse}")
                group = max(group, err)
            errs.append(f"2^{log_n}/0..{min(nk.LOG_TILE, log_n)}={group}")
            del x, plain
        for log_n, stages in NTT_STAGE_CHECKS:
            x = random_table(ctx, rng, 1 << log_n, edges=edges)
            group = 0
            for stage in stages:
                err = max_abs_err(nk.ntt_stage(ctx, x, tws[log_n], stage),
                                  nk.ntt_stage_plain(ctx, x, tws[log_n], stage))
                note("ntt_stage", err, f"2^{log_n}, stage {stage}, inverse={inverse}")
                group = max(group, err)
            errs.append(f"ntt_stage 1..{stages[-1]} of 2^{log_n}={group}")
        torch.cuda.synchronize()
        say(f"  bn254_fr {'inverse' if inverse else 'forward'}: ntt_phase1 (2^log_n/log tiles=err) "
            f"{' '.join(errs)}")
    say("  the card's twiddle tables == the CPU's at 2^12, forward and inverse")
    return worst


def ntt_benchmark(ctx, log_n: int):
    """The NTT path's table: 2^log_n elements of 8 words drawn uniformly below
    2^256 from numpy seed 0, which ``to_mont`` reduces mod r into Montgomery form
    (one ``mont_mul`` launch). Returns (the device table, the host coefficients)."""
    rng = np.random.default_rng(0)
    words = rng.integers(0, 1 << 32, size=(1 << log_n, ctx.num_words), dtype=np.uint32)
    p = ctx.spec.modulus
    coeffs = [int(v) % p for v in ctx.unpack(words)]
    return fk.to_mont(ctx, ctx.to_device(words)), coeffs


def ntt_expected(log_n: int, inverse: bool, first: bool) -> dict[str, int]:
    """Launches of one ``ntt`` call: a phase-1 pass, a pass a later stage; the
    first call of a (size, direction) builds its twiddles (log_n - 1 products),
    the inverse scales by 1/n (one)."""
    return {"ntt_phase1": 1, "ntt_stage": max(0, log_n - nk.LOG_TILE),
            "mont_mul": (log_n - 1 if first else 0) + int(inverse)}


def launched(fn):
    """(fn(), the launches of the NTT path's three kernels that it made)."""
    names = nk.KERNEL_NAMES + ("mont_mul",)
    before = all_launches()
    out = fn()
    after = all_launches()
    return out, {name: after[name] - before[name] for name in names}


def phase_ntt_main_path(ctx):
    spec = ctx.spec
    set_up = {log_n: ntt_benchmark(ctx, log_n) for log_n in NTT_LOG_SIZES}
    reset_all_launches()
    results = {}
    for log_n in NTT_LOG_SIZES:
        x = set_up[log_n][0]
        for first in (True, False):
            fwd, got_f = launched(lambda: tn.ntt(ctx, x))
            back, got_b = launched(lambda: tn.ntt(ctx, fwd, inverse=True))
            for got, inverse in ((got_f, False), (got_b, True)):
                want = ntt_expected(log_n, inverse, first)
                check(got == want, f"launches of {'first' if first else 'warm'} ntt 2^{log_n} "
                      f"inverse={inverse}: {got} != {want}")
            say(f"  2^{log_n} {'first' if first else 'warm '}: launches {got_f} / {got_b}")
        results[log_n] = (x, set_up[log_n][1], fwd, back)

    log_n = NTT_LOG_SIZES[0]
    poly = UnivariatePoly(spec, results[log_n][1])
    evals, got_e = launched(lambda: tn.fft_evaluate(poly))
    interp, got_i = launched(lambda: tn.fft_interpolate(spec, evals))
    stages = log_n - nk.LOG_TILE
    check(got_e == {"ntt_phase1": 1, "ntt_stage": stages, "mont_mul": 2},
          f"launches of fft_evaluate: {got_e}")
    check(got_i == {"ntt_phase1": 1, "ntt_stage": stages, "mont_mul": 3},
          f"launches of fft_interpolate: {got_i}")
    launches = all_launches()
    say(f"  launches on the NTT path: {launches}")
    check(all(v == 0 for k, v in launches.items() if k not in nk.KERNEL_NAMES + ("mont_mul",)),
          "the NTT path launched another path's kernel")
    return results, poly, evals, interp, launches


def phase_ntt_ties(ctx, results, poly, evals, interp) -> None:
    spec = ctx.spec
    p = spec.modulus
    for log_n, (x, coeffs, fwd, back) in results.items():
        n = 1 << log_n
        check(torch.equal(back, x), f"ntt(ntt(x), inverse) != x at 2^{log_n}")
        rows = [0, 1, n // 2, int(np.random.default_rng(0).integers(2, n))]
        omega = spec.root_of_unity(n)
        got = [int(v) for v in ctx.unpack(fk.from_mont(ctx, fwd[rows].contiguous()))]
        host = UnivariatePoly(spec, coeffs)
        want = [host.evaluate(pow(omega, i, p)) for i in rows]
        check(got == want, f"ntt outputs {rows} at 2^{log_n} are not the host's Horner evaluations")
        if log_n == NTT_LOG_SIZES[0]:
            check([evals[i] for i in rows] == want, "fft_evaluate differs from ntt")
        say(f"  2^{log_n}: inverse(ntt(x)) == x; outputs {rows} == Horner at w^i")
    check(interp.coefficients == poly.coefficients,
          "fft_interpolate(fft_evaluate(poly)) is not poly")
    say(f"  fft_interpolate(fft_evaluate(poly)) == poly at 2^{NTT_LOG_SIZES[0]}")

    cpu = fb.get_ctx(spec, device="cpu")
    x = random_table(ctx, np.random.default_rng(10), 1 << NTT_CPU_TIE_LOG)
    for inverse in (False, True):
        check(torch.equal(tn.ntt(ctx, x, inverse).cpu(), tn.ntt(cpu, x.cpu(), inverse)),
              f"2^{NTT_CPU_TIE_LOG} ntt on the card differs from the CPU's (inverse={inverse})")
    say(f"  2^{NTT_CPU_TIE_LOG} ntt and inverse on the card == on the CPU")


#: run_scan's two device kernels, one of each a launch: the one pass over the
#: keys, and the fill of the slots past the count
SCAN_PASSES = ("run_scan_tiles", "run_scan_fill")
#: what the device kernels of torch.cummax and torch.searchsorted have in their
#: names (``scan_op_kernels`` checks it on the card's PyTorch)
SCAN_OP_NEEDLES = {"cummax": "_with_indices", "searchsorted": "searchsorted"}


def kernel_names_of(fn) -> dict[str, int]:
    """The device kernels ``fn`` runs, by name, counted by the profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names: dict[str, int] = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type().name == "CUDA":
            names[e.name()] = names.get(e.name(), 0) + 1
    return names


def scan_op_kernels() -> None:
    """``SCAN_OP_NEEDLES`` names the device kernels of torch.cummax and
    torch.searchsorted on this card's PyTorch (on the keys and counts of a
    compaction round: int64 positions, sorted int64 sums), so that a path
    without such a kernel is one that runs neither op."""
    x = torch.arange(1 << 16, device="cuda")
    for op, fn in (("cummax", lambda: torch.cummax(x, dim=0)),
                   ("searchsorted", lambda: torch.searchsorted(x, x[:100]))):
        names = kernel_names_of(fn)
        found = [name for name in names if SCAN_OP_NEEDLES[op] in name]
        check(found, f"no device kernel of torch.{op} has {SCAN_OP_NEEDLES[op]!r} in its name: "
              f"{sorted(names)}")
        say(f"  torch.{op}'s device kernels: {found}")


def scan_op_runs(kernel_names: dict[str, int]) -> dict[str, int]:
    """Device kernels of torch.cummax and torch.searchsorted among a profile's."""
    return {op: sum(n for name, n in kernel_names.items() if needle in name)
            for op, needle in SCAN_OP_NEEDLES.items()}


#: seconds that a profile's window stays open before and after the profiled
#: run. The tracer keeps only the device records whose times, on its clock,
#: fall inside its window; late in this process a profile of the mesh path has
#: come up a few MSM records short at a time (2 of 667 compact_add, 1 of 57
#: horner), as if its clock had drifted from the host's past the edge of a
#: window closed at once.
PROFILE_PAD_S = 0.5
#: profiles of the mesh path taken at most, while the tracer's counts only fall
#: short of the launches
PROFILE_TRIES = 3


def profile_path(fn) -> dict:
    """Run ``fn`` once under torch.profiler (device activity only): its
    launches by kernel, the device kernels that ran by the device function's
    name (``finish_rows``, the second pass of the three summing kernels, and
    run_scan's two kernels apart), and the device kernels of torch.cummax and
    torch.searchsorted that ran. The window opens PROFILE_PAD_S before the run
    and closes PROFILE_PAD_S after it."""
    from torch.profiler import ProfilerActivity, profile

    reset_all_launches()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    names = (fk.KERNEL_NAMES + pk.KERNEL_NAMES + nk.KERNEL_NAMES + tk.KERNEL_NAMES
             + mk.KERNEL_NAMES + gk.KERNEL_NAMES + gt.KERNEL_NAMES + ("finish_rows",)
             + SCAN_PASSES)
    device_n = {name: 0 for name in names}
    pattern = re.compile(r"\b(" + "|".join(names) + r")_kernel\b")
    kernel_names: dict[str, int] = {}
    # the raw events, not key_averages(): a path launches up to some 600,000
    # kernels, and building the averaged tree takes minutes
    for e in prof.profiler.kineto_results.events():
        if e.device_type().name == "CUDA":
            name = e.name()
            kernel_names[name] = kernel_names.get(name, 0) + 1
            found = pattern.search(name)
            if found:
                device_n[found.group(1)] += 1
    return {"launches": all_launches(), "device_n": device_n,
            "scan_ops": scan_op_runs(kernel_names)}


def msm_launch_faults(path: str, p: dict) -> list[str]:
    """Where a profile breaks check_msm_launches' rule."""
    ran, launched = p["device_n"], p["launches"]
    faults = []
    for name in ("compact_add", "horner") + SCAN_PASSES:
        want = launched["run_scan" if name in SCAN_PASSES else name]
        if ran[name] != want:
            faults.append(f"{path}: {ran[name]} {name} kernels ran for {want} launches")
    if any(p["scan_ops"].values()):
        faults.append(f"{path} ran torch.cummax or torch.searchsorted kernels: {p['scan_ops']}")
    return faults


def check_msm_launches(path: str, p: dict) -> None:
    """compact_add and horner are one device kernel a wrapper launch, run_scan
    one of each of its two kernels; no cummax or searchsorted kernel runs."""
    faults = msm_launch_faults(path, p)
    check(not faults, "; ".join(faults))


def check_one_launch(profiles: dict[str, dict]) -> None:
    """halves_sums, fold_and_halves, the two transcript kernels, the two GKR
    phase kernels and the three GKR table kernels are one device kernel a
    wrapper launch (the table kernels a layer's three, the verifier's wiring a
    layer), and finish_rows runs
    after gkr_round alone: on every profiled path the device's count of each
    kernel equals its wrapper's launches, so the sumcheck path (1 + 19
    launches, no gkr_round) runs no finish_rows. The sumcheck's transcript is a
    round_step a round; the GKR paths' rounds are a gkr_big_round each above
    ``fused_lazy.TAIL_MAX`` entries and a gkr_phase_tail a phase, with no
    gkr_round, finish_rows or round_step; no path launches keccak_f (its
    permutations run inside round_step and the phase kernels). The MSM kernels
    as ``check_msm_launches`` says, and the KZG path's window combines two
    horner launches (the commitment's, every quotient step's), with no
    point_double."""
    one_launch = fk._ONE_LAUNCH + tk.KERNEL_NAMES + gk.KERNEL_NAMES + gt.KERNEL_NAMES
    walk = gkr_expected_launches(GKR_NUM_VARS)
    for path, p in profiles.items():
        ran, launched = p["device_n"], p["launches"]
        for name in one_launch:
            check(ran[name] == launched[name],
                  f"{path}: {ran[name]} {name} kernels ran for {launched[name]} launches")
        check(ran["finish_rows"] == launched["gkr_round"],
              f"{path}: {ran['finish_rows']} finish_rows kernels ran for "
              f"{launched['gkr_round']} gkr_round launches")
        check(launched["keccak_f"] == 0, f"{path} launched keccak_f")
        check(launched["round_step"] == (NUM_VARS if path == "sumcheck" else 0),
              f"{path}: {launched['round_step']} round_step launches")
        for name in ("gkr_round",) + gk.KERNEL_NAMES + gt.KERNEL_NAMES:
            want = walk[name] if path.startswith("gkr") else 0
            check(launched[name] == want, f"{path}: {launched[name]} {name} launches, not {want}")
        check_msm_launches(path, p)
    kzg = profiles["gkr_kzg"]
    check(kzg["launches"]["horner"] == 2 and kzg["launches"]["point_double"] == 0
          and kzg["launches"]["run_scan"] == KZG_COMPACT_ROUNDS_2E20,
          f"profiled gkr.prove: horner, point_double, run_scan launches {kzg['launches']}")
    sumcheck = profiles["sumcheck"]
    for name in fk._ONE_LAUNCH + ("round_step",):
        check(sumcheck["launches"][name] == EXPECTED_LAUNCHES[name],
              f"profiled sumcheck: {sumcheck['launches'][name]} {name} launches")
    check(sumcheck["device_n"]["finish_rows"] == 0, "finish_rows ran on the sumcheck path")
    say("  one device kernel a launch of halves_sums, fold_and_halves, round_step, keccak_f, "
        "gkr_big_round, gkr_phase_tail, compact_add and horner on every path, two of run_scan, "
        "no gkr_round, finish_rows or round_step on the GKR paths, no cummax or searchsorted "
        "kernel: " + ", ".join(
            f"{path} {p['device_n']['halves_sums']} + {p['device_n']['fold_and_halves']}, "
            f"round_step {p['device_n']['round_step']}, gkr_big_round "
            f"{p['device_n']['gkr_big_round']}, gkr_phase_tail {p['device_n']['gkr_phase_tail']}, "
            f"gkr_round {p['device_n']['gkr_round']}, finish_rows {p['device_n']['finish_rows']}, "
            f"run_scan kernels {[p['device_n'][name] for name in SCAN_PASSES]}, compact_add "
            f"{p['device_n']['compact_add']}, horner {p['device_n']['horner']}, "
            f"scan ops {p['scan_ops']}" for path, p in profiles.items()))


def phase_profiles(ctx, gctx, rctx, circuit, inputs, taus, ntt_inputs, ntt_poly) -> dict[str, dict]:
    """Each main path once more under the profiler, as phases 3, 5, 8 and 12
    drove it (the NTT's twiddle tables are cached by then)."""
    values = benchmark_values(NUM_VARS)

    def sumcheck():
        poly = MultilinearPoly.from_ints(ctx, values)
        check(protocol.verify(poly, fused.prove(poly)), "profiled sumcheck refused")

    def layers():
        proved = gkr.prove_layers(circuit, inputs)
        check(gkr.verify_layers(proved.proof, circuit, proved.input_evals).verified,
              "profiled verify_layers refused")

    def whole():
        check(gkr.verify(gkr.prove(circuit, inputs, taus=taus), circuit), "profiled verify refused")

    def ntt_path():
        for x in ntt_inputs.values():
            for _ in range(2):
                tn.ntt(rctx, tn.ntt(rctx, x), inverse=True)
        tn.fft_interpolate(rctx.spec, tn.fft_evaluate(ntt_poly))

    out = {}
    for name, fn in (("sumcheck", sumcheck), ("gkr_walk", layers), ("gkr_kzg", whole),
                     ("ntt", ntt_path)):
        out[name] = profile_path(fn)
        torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------------
# phase 15: proof bytes and the field oracle
# ----------------------------------------------------------------------

def oracle_values(spec, rng, n: int) -> list[int]:
    """n random canonical elements of ``spec``, the first three 0, 1 and p - 1."""
    p = spec.modulus
    values = [int.from_bytes(rng.bytes(spec.byte_len), "little") % p for _ in range(n)]
    values[:3] = [0, 1, p - 1]
    return values


def oracle_mismatches(ctx, rng, log_size: int, every_kernel: bool = True) -> dict[str, int]:
    """The field layer on ``ctx``'s device against the oracle, which shares no
    code with it: entries that differ, by kernel or function. Tables of
    2^log_size random elements with 0, 1 and p - 1 among them, through
    ``to_mont`` / ``from_mont``; the folds at a random r, 0, 1 and p - 1;
    ``pow_static`` at a random 64-bit exponent. ``every_kernel`` False:
    ``mont_mul`` alone. The oracle's products, powers and inverses run on every
    host core while the card works (its C calls release the interpreter lock)."""
    p = ctx.spec.modulus
    n = 1 << log_size
    a = oracle_values(ctx.spec, rng, n)
    b = oracle_values(ctx.spec, rng, n)
    b = b[1:] + b[:1]  # edge against edge, and each edge against a random value
    exponent = int(rng.integers(0, 1 << 63)) | (1 << 63)

    def to_card(values):
        return fk.to_mont(ctx, ctx.to_device(ctx.pack(values)))

    def ints(table):
        return [int(v) for v in ctx.unpack(fk.from_mont(ctx, table)).reshape(-1)]

    def differ(got, want):
        want = list(want)
        return sum(x != y for x, y in zip(got, want)) + abs(len(got) - len(want))

    with ThreadPoolExecutor(os.cpu_count()) as pool:
        want = {"mont_mul": pool.map(lambda x, y: oracle.mul(x, y, p), a, b)}
        if every_kernel:
            want["pow_static"] = pool.map(lambda x: oracle.pow_(x, exponent, p), a)
            want["inverse"] = pool.map(lambda x: oracle.inverse(x, p), a)
        a_mont = to_card(a)
        got = {"mont_mul": ints(fk.mont_mul(ctx, a_mont, to_card(b)))}
        if every_kernel:
            got["pow_static"] = ints(fb.pow_static(ctx, a_mont, exponent))
            got["inverse"] = ints(fb.inverse(ctx, a_mont))
        bad = {name: differ(got[name], want[name]) for name in got}
    if not every_kernel:
        return bad
    half = n // 2
    bad["halves_sums"] = differ(fk.lazy_rows_to_ints(ctx, fk.halves_sums(ctx, a_mont)),
                                [oracle.vec_sum(a[:half], p), oracle.vec_sum(a[half:], p)])
    bad["fold"] = bad["fold_and_halves"] = 0
    for r in (int.from_bytes(rng.bytes(ctx.spec.byte_len), "little") % p, 0, 1, p - 1):
        folds = oracle.sumcheck_fold(a, r, p)
        r_mont = to_card(r)
        bad["fold"] += differ(ints(fk.fold(ctx, a_mont, r_mont)), folds)
        folded, rows = fk.fold_and_halves(ctx, a_mont, r_mont)
        quarter = n // 4
        bad["fold_and_halves"] += differ(ints(folded), folds) + differ(
            fk.lazy_rows_to_ints(ctx, rows),
            [oracle.vec_sum(folds[:quarter], p), oracle.vec_sum(folds[quarter:], p)])
    return bad


def phase_oracle() -> None:
    rng = np.random.default_rng(11)
    for spec, every_kernel in ORACLE_FIELDS:
        ctx = fb.get_ctx(spec)
        bad = oracle_mismatches(ctx, rng, ORACLE_LOG_SIZE, every_kernel)
        say(f"  {spec.name} (W = {ctx.num_words}), 2^{ORACLE_LOG_SIZE} entries: mismatches "
            + " ".join(f"{k}={v}" for k, v in bad.items()))
        for name, count in bad.items():
            check(count == 0, f"{name} differs from the oracle on {spec.name}")


def tampered_blobs(blob: bytes, proof) -> dict[str, bytes]:
    """Three copies of a GKR proof blob, each with one byte changed: the low
    byte of the first output value, the infinity flag of the commitment, the
    top byte of the layer count. ``proof`` is the blob's proof (its input
    proof's length locates the commitment)."""
    n_out = struct.unpack_from("<I", blob, 1)[0]
    kzg_at = len(blob) - len(ser.encode_kzg_proof(proof.input_proof))
    flips = {"field element": (5, 0x01),
             "G1 flag byte": (kzg_at + ser.G1_BYTES, 0x40),
             "length prefix": (1 + 4 + n_out * BLS12_381_FR.byte_len + 3, 0x01)}
    out = {}
    for name, (at, bit) in flips.items():
        bad = bytearray(blob)
        bad[at] ^= bit
        out[name] = bytes(bad)
    return out


def blob_verdict(blob: bytes, circuit) -> str:
    """"raised" (``ValueError`` on decode), "refused" or "accepted" by
    ``gkr.verify``; any other exception propagates."""
    try:
        proof = ser.decode_gkr_proof(blob, circuit.ctx.device)
    except ValueError:
        return "raised"
    return "accepted" if gkr.verify(proof, circuit) else "refused"


def walk_of(proof, walk) -> gkr.LayersProof:
    """A whole proof's layer walk at the point pair of ``walk``, with its opened
    evaluations as the input evaluations."""
    return gkr.LayersProof(proof, walk.r_b, walk.r_c, tuple(proof.input_proof.opened_evals))


def phase_proof_bytes(sum_proof, gkr_blob: bytes, kept, circuit, walk) -> None:
    """The 2^20 sumcheck proof and the whole 2^20-input GKR proof as bytes:
    digest, round trips, the decoded proof against the one in memory (``kept``,
    without its device SRS), verify on the card, three tampered blobs."""
    blob = ser.encode_sumcheck_proof(sum_proof, BN254_FQ)
    back = ser.decode_sumcheck_proof(blob, BN254_FQ)
    digest = hk.keccak256(blob).hex()
    say(f"  2^{NUM_VARS} sumcheck blob: {len(blob)} bytes; digest {digest}")
    check(digest == SUMCHECK_BLOB_DIGEST_2E20,
          f"sumcheck blob digest differs from the stored {SUMCHECK_BLOB_DIGEST_2E20}")
    check(back == sum_proof and ser.encode_sumcheck_proof(back, BN254_FQ) == blob,
          "the sumcheck blob does not round-trip")
    # both blobs hashed on the card as well: keccak256_device, a keccak_f launch a block
    for name, data in (("sumcheck", blob), ("GKR", gkr_blob)):
        before = tk.launches["keccak_f"]
        on_card = kd.digest_to_bytes(kd.keccak256_device(data, "cuda"))
        blocks = len(data) // kd.RATE + 1
        check(on_card == hk.keccak256(data), f"the {name} blob's digest on the card differs")
        check(tk.launches["keccak_f"] - before == blocks, f"{name} blob: not a keccak_f a block")
        say(f"  the {name} blob's digest on the card == the host's: {blocks} keccak_f launches")

    decoded = ser.decode_gkr_proof(gkr_blob)
    say(f"  2^{GKR_NUM_VARS}-input GKR proof blob: {len(gkr_blob)} bytes, decoded onto the card "
        "(device None)")
    check(decoded.output_poly.table.device == circuit.ctx.device,
          "the decoded output table is not on the card")
    check(ser.encode_gkr_proof(decoded) == gkr_blob, "the GKR blob does not round-trip")
    check(same_layers_proof(walk_of(decoded, walk), walk_of(kept, walk))
          and same_input_proof(decoded.input_proof, kept.input_proof)
          and decoded.input_proof.kzg_setup.g2_taus == kept.input_proof.kzg_setup.g2_taus,
          "the decoded GKR proof differs from the proof in memory")
    check(gkr.verify(decoded, circuit), "verify refused the GKR proof decoded from bytes")
    say("  decoded GKR proof == the proof in memory; re-encodes to the same bytes; "
        "gkr.verify accepts it on the card")
    verdicts = {name: blob_verdict(bad, circuit) for name, bad in tampered_blobs(gkr_blob, kept).items()}
    say(f"  tampered blobs: {verdicts}")
    for name, verdict in verdicts.items():
        check(verdict in ("raised", "refused"), f"a blob with a changed {name} was accepted")


# ----------------------------------------------------------------------
# phase 16: the mesh paths
# ----------------------------------------------------------------------

def phase_batched_ntt_kernels_vs_plain() -> dict[str, int]:
    """ntt_phase1 (at the full tile) and every later ntt_stage on batches of
    tables, forward and inverse twiddles, word for word against the plain
    versions."""
    ctx = fb.get_ctx(BN254_FR)
    rng = np.random.default_rng(16)
    p = ctx.spec.modulus
    edges = (0, 1, p - 1, ctx.spec.R % p)
    worst = {name: 0 for name in nk.KERNEL_NAMES}
    for log_n, batch in NTT_BATCH_CHECKS:
        x = random_table(ctx, rng, batch, 1 << log_n, edges=edges)
        errs = []
        for inverse in (False, True):
            tw = nk.stage_twiddles(ctx, log_n, inverse)
            log_tile = min(nk.LOG_TILE, log_n)
            y = nk.ntt_phase1(ctx, x, tw, log_tile)
            err = max_abs_err(y, nk.ntt_phase1_plain(ctx, x, tw, log_tile))
            check(err == 0, f"batched ntt_phase1 differs from its plain version "
                  f"({batch} x 2^{log_n}, inverse={inverse})")
            errs.append(err)
            for stage in range(log_tile + 1, log_n + 1):
                err = max_abs_err(nk.ntt_stage(ctx, y, tw, stage),
                                  nk.ntt_stage_plain(ctx, y, tw, stage))
                check(err == 0, f"batched ntt_stage differs from its plain version "
                      f"({batch} x 2^{log_n}, stage {stage}, inverse={inverse})")
                worst["ntt_stage"] = max(worst["ntt_stage"], err)
        worst["ntt_phase1"] = max(worst["ntt_phase1"], *errs)
        del x
    torch.cuda.synchronize()
    say("  batched ntt_phase1 and ntt_stage == their plain versions, forward and inverse, on "
        + ", ".join(f"{b} x 2^{k}" for k, b in NTT_BATCH_CHECKS))

    return worst


def sharded_sumcheck_expected(n: int, d: int) -> dict[str, int]:
    """halves_sums and fold launches of ``sumcheck_prove_sharded`` at 2^n
    entries on d slots: the claimed sum's d, then d of each a round until a
    shard has one row (n - log2 d rounds), then one of each a gathered round."""
    log_d = d.bit_length() - 1
    return {"halves_sums": d + d * (n - log_d) + log_d, "fold": d * (n - log_d) + log_d}


def sharded_ntt_expected(log_n: int, d: int) -> dict[str, int]:
    """ntt_phase1 and ntt_stage launches of ``ntt_sharded`` on d slots: one of
    each a stage past the tile, a slot and a phase (rows of 2^(log_n // 2),
    then of the rest), each over all the slot's rows in one launch."""
    log_n1 = log_n // 2
    stages = max(0, log_n - log_n1 - nk.LOG_TILE) + max(0, log_n1 - nk.LOG_TILE)
    return {"ntt_phase1": 2 * d, "ntt_stage": d * stages}


def delta(before: dict, after: dict, names) -> dict[str, int]:
    return {name: after[name] - before[name] for name in names}


def mesh_sumcheck(mesh, ctx, sum_proof):
    values = benchmark_values(NUM_VARS)
    poly = MultilinearPoly.from_ints(ctx, values)
    before = all_launches()
    sharded = pm.sumcheck_prove_sharded(poly, mesh)
    got = delta(before, all_launches(), ("halves_sums", "fold"))
    want = sharded_sumcheck_expected(NUM_VARS, mesh.size)
    check(got == want, f"sharded sumcheck launches {got} != {want}")
    check(sharded.claimed_sum == sum_proof.claimed_sum
          and sharded.proof_polynomials == sum_proof.proof_polynomials,
          "the sharded sumcheck proof differs from phase 3's")
    check(proof_digest(ctx.spec, sharded) == PROOF_DIGEST_2E20, "sharded proof digest differs")
    say(f"  2^{NUM_VARS} sumcheck_prove_sharded == phase 3's proof, digest {PROOF_DIGEST_2E20[:16]}..; "
        f"launches {got}")


def mesh_ntt(mesh, rctx, ntt_outputs):
    for log_n, (x, fwd) in ntt_outputs.items():
        for inverse, src, want in ((False, x, fwd), (True, fwd, x)):
            before = all_launches()
            out = pm.ntt_sharded(rctx, mesh, src, inverse)
            got = delta(before, all_launches(), nk.KERNEL_NAMES)
            expected = sharded_ntt_expected(log_n, mesh.size)
            check(got == expected, f"ntt_sharded launches at 2^{log_n}: {got} != {expected}")
            check(torch.equal(out, want), f"ntt_sharded 2^{log_n} (inverse={inverse}) differs from "
                  f"phase 12's")
    say(f"  ntt_sharded forward and inverse at " + " and ".join(f"2^{k}" for k in ntt_outputs)
        + " == phase 12's ntt outputs and inputs; one ntt_phase1 a slot and a phase")


def mesh_commitment(mesh, gctx, inputs, taus, commitment):
    input_poly = MultilinearPoly.from_ints(gctx, inputs)
    basis = KZG.for_poly(input_poly, taus).g1_lagrange_basis
    scalars = fk.from_mont(gctx, input_poly.table)
    check(pctx.shardable(scalars.shape[0], mesh), "the commitment MSM does not shard")
    jac = pm.msm_pippenger_sharded(mesh, basis, scalars)
    check(dc.unpack_points(tuple(t[None] for t in jac))[0] == commitment,
          "msm_pippenger_sharded of the commitment differs from phase 8's")
    ladder = pm.msm_sharded(mesh, basis, scalars)
    check(dc.unpack_points(tuple(t[None] for t in ladder))[0] == commitment,
          "msm_sharded (the ladder) of the commitment differs from phase 8's")
    say(f"  msm_pippenger_sharded and msm_sharded (the double-and-add ladder) of the "
        f"2^{GKR_NUM_VARS}-point commitment == phase 8's commitment (window "
        f"{pp.pick_window_bits((1 << GKR_NUM_VARS) // mesh.size)} a slot)")


def phase_mesh_paths(ctx, gctx, rctx, sum_proof, circuit, inputs, taus, gkr_blob, commitment,
                     ntt_outputs):
    """The mesh paths on the one-card mesh of MESH_SLOTS slots and on the mesh of
    every card present. Returns the launches of the paths (the profiled rerun
    not counted)."""
    meshes = [("4-slot", pm.make_mesh(devices=[torch.device("cuda", 0)] * MESH_SLOTS)),
              ("all-cards", pm.make_mesh())]
    launches = {name: 0 for name in all_launches()}
    for label, mesh in meshes:
        say(f"  -- {label} mesh: {mesh}")
        reset_all_launches()
        mesh_sumcheck(mesh, ctx, sum_proof)
        mesh_ntt(mesh, rctx, ntt_outputs)
        mesh_commitment(mesh, gctx, inputs, taus, commitment)
        if label == "4-slot":
            blob = ser.encode_gkr_proof(gkr.prove(circuit, inputs, taus=taus, mesh=mesh))
            check(blob == gkr_blob, "gkr.prove(mesh=...) does not encode to phase 8's bytes")
            say(f"  gkr.prove(mesh=...) of the 2^{GKR_NUM_VARS}-input circuit encodes to phase 8's "
                f"{len(blob)} bytes")
        dryrun_multichip(mesh)
        say("  dryrun_multichip passes")
        got = all_launches()
        say(f"  launches on the {label} mesh's paths: {got}")
        for name, v in got.items():
            launches[name] += v
        if label == "4-slot":
            # its sharded commitment and segment-sharded quotient MSMs once more,
            # under the profiler (not counted above)
            # Late in this process the tracer has dropped a few of this run's
            # several hundred thousand kernel records (see PROFILE_PAD_S): a
            # profile whose counts only fall short of the launches is taken
            # again, up to PROFILE_TRIES in all, and the last must hold exactly
            for attempt in range(1, PROFILE_TRIES + 1):
                prof = profile_path(lambda: gkr.prove(circuit, inputs, taus=taus, mesh=mesh))
                faults = msm_launch_faults("gkr.prove(mesh=...)", prof)
                short = not any(prof["scan_ops"].values()) and all(
                    prof["device_n"][name] <= prof["launches"]["run_scan" if name in SCAN_PASSES
                                                               else name]
                    for name in ("compact_add", "horner") + SCAN_PASSES)
                if not (faults and short) or attempt == PROFILE_TRIES:
                    break
                say(f"  profile {attempt} fell short: {faults}")
            check(not faults, "; ".join(faults))
            say(f"  gkr.prove(mesh=...) under the profiler: run_scan {prof['launches']['run_scan']}, "
                f"compact_add {prof['launches']['compact_add']}, horner "
                f"{prof['launches']['horner']} launches, one device kernel each (run_scan two); "
                f"cummax and searchsorted kernels {prof['scan_ops']}")
        torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------------------------
# phase 17: the transcript kernels
# ----------------------------------------------------------------------

#: keccak_f against its plain version on batches of this many random states
KECCAK_CHECK_STATES = (1, 33, 4096)
#: round_step against its plain version: (rows, pending tail lanes or None for
#: a steady round, trimmed length of GKR's coefficients). Sumcheck tails of 8
#: and 9 lanes take round 0's content into one block and two; GKR tails of 8
#: lanes keep 0-2 coefficients in one block and carry 3 into two, of 16 lanes
#: carry 1-3 and leave 0 in one.
ROUND_CHECKS = (
    ((2, None, 2), (2, 0, 2), (2, 8, 2), (2, 9, 2), (2, 16, 2))
    + tuple((3, None, m) for m in range(4))
    + tuple((3, tail, m) for tail in (0, 8, 16) for m in range(4))
)


def lane_err(a, b) -> int:
    """The largest absolute difference of the 32-bit words of two lane tensors."""
    if a.shape != b.shape:
        return -1
    return max_abs_err(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def random_lanes(rng, n: int, device):
    return torch.from_numpy(rng.integers(0, 1 << 64, size=n, dtype=np.uint64).view(np.int64)).to(
        device)


def round_check_inputs(ctx, rng, k: int, tail, m: int):
    """Lazy rows, state and tail of one round: rows whose values are two
    half-sums (k = 2) or the values at t = 0, 1, 2 of a polynomial of trimmed
    length m (k = 3), each as S = v R mod p + j p, row 0 with j = 1 (low words
    at or above p), the others a random j below 2^32 (a high word)."""
    p, r = ctx.spec.modulus, ctx.spec.R
    if k == 2:
        values = [int(v) % p for v in rng.integers(0, 1 << 62, size=2)]
    else:
        coeffs = [int(rng.integers(1, 1 << 62)) if i < m else 0 for i in range(3)]
        values = [(coeffs[0] + coeffs[1] * t + coeffs[2] * t * t) % p for t in range(3)]
    sums = [v * r % p + (1 if i == 0 else int(rng.integers(1, 1 << 32))) * p
            for i, v in enumerate(values)]
    rows = ctx.to_device(np.stack([
        np.frombuffer(x.to_bytes(4 * (ctx.num_words + 1), "little"), dtype="<u4") for x in sums]))
    state = random_lanes(rng, 25, ctx.device)
    return rows, state, None if tail is None else random_lanes(rng, tail, ctx.device)


def phase_transcript_kernels() -> dict[str, int]:
    """keccak_f and round_step against their plain versions, word for word."""
    errs = {name: 0 for name in tk.KERNEL_NAMES}
    rng = np.random.default_rng(17)
    device = torch.device("cuda")
    for b in KECCAK_CHECK_STATES:
        states = random_lanes(rng, 25 * b, device).reshape(b, 25)
        states[0] = 0
        err = lane_err(tk.keccak_f(states), tk.keccak_f_plain(states))
        check(err == 0, f"keccak_f differs from its plain version on {b} states")
        errs["keccak_f"] = max(errs["keccak_f"], err)
    say(f"  keccak_f on {', '.join(map(str, KECCAK_CHECK_STATES))} random states (the zero "
        f"state first): max error {errs['keccak_f']}")
    for spec in (BN254_FQ, BLS12_381_FR):
        ctx = fb.get_ctx(spec)
        at_or_above_p = 0
        for k, tail, m in ROUND_CHECKS:
            rows, state, tail_lanes = round_check_inputs(ctx, rng, k, tail, m)
            got = tk.round_step(ctx, rows, state, tail_lanes)
            want = tk.round_step_plain(ctx, rows, state, tail_lanes)
            err = max(max_abs_err(got[0], want[0]), lane_err(got[1], want[1]),
                      max_abs_err(got[2], want[2]))
            check(err == 0, f"round_step differs from its plain version ({spec.name}, "
                  f"k = {k}, tail {tail}, trimmed length {m})")
            errs["round_step"] = max(errs["round_step"], err)
            digest = kd.digest_to_bytes(got[1][:4])
            at_or_above_p += int.from_bytes(digest, "little") >= spec.modulus
        check(at_or_above_p > 0, f"no digest at or above p for {spec.name}")
        say(f"  round_step, {spec.name}: {len(ROUND_CHECKS)} rounds (2 and 3 rows, trimmed "
            f"lengths 0-3, steady and first rounds of one and two blocks, low words at or above "
            f"p; {at_or_above_p} digests at or above p): max error {errs['round_step']}")
    return errs


# ----------------------------------------------------------------------
# phase 18: the MSM kernels
# ----------------------------------------------------------------------

#: run_scan and compact_add against their plain versions at these key counts
#: (compact_add on random points, and at 2^24 on the commitment's first round
#: too); above COMPACT_CHECK_TOP compact_add on one key set at the survivor
#: count, on the random-point pool repeated
SCAN_CHECK_WIDTHS = (1, 2, 3, 127, 128, 129, 4095, 4096, 4097, 1 << 16, (1 << 16) + 1, 1 << 20,
                     1 << 24)
COMPACT_CHECK_TOP = 1 << 20
#: run lengths of the key set whose runs cross the scan's threads' runs (16
#: keys) and its tiles (4096 keys)
CROSSING_RUNS = (1, 2, 3, 15, 16, 17, 31, 33, 4095, 4096, 4097, 8193)
#: horner against its plain version: segments, window widths, points a segment;
#: below c = 16 over the most significant windows only (a plain chain is some
#: 250 doublings of about 0.1 s each on the card, launch-bound; the whole
#: chains at c = 4 and 8 are held against the eager chain, HORNER_EAGER_SHAPES)
HORNER_CHECK_SEGMENTS = (1, 2, 4)
HORNER_CHECK_WINDOWS = (4, 8, 16)
HORNER_CHECK_POINTS = 1 << 10
HORNER_CHECK_TOP_WINDOWS = 8
#: whole Horner chains held against the eager chain after the commitment's, at
#: the quotient steps' shapes: (segments, c)
HORNER_EAGER_SHAPES = ((2, 16), (2, 8), (2, 4))
#: phase 18's fq_mul_coop against the oracle: entries (phase 15's 2^12)
COOP_CHECK_LOG = ORACLE_LOG_SIZE


def scan_key_sets(rng, n: int, device) -> dict[str, torch.Tensor]:
    """Sorted int32 keys of n entries on ``device``: random runs, all equal, all
    distinct, runs whose lengths cross the scan's tiles and blocks, and a
    MAXKEY tail."""
    lengths = rng.choice(CROSSING_RUNS, size=n)
    lengths = lengths[: int(np.searchsorted(np.cumsum(lengths), n)) + 1]
    runs = np.repeat(np.arange(lengths.shape[0]), lengths)
    tail = n // 4
    sets = {
        "random runs": np.sort(rng.integers(0, max(1, n // 8), size=n)),
        "all equal": np.full(n, 7),
        "all distinct": np.arange(n),
        "runs across tiles and blocks": runs[:n],
        "MAXKEY tail": np.concatenate([np.sort(rng.integers(0, max(1, n // 8), size=n - tail)),
                                       np.full(tail, mk.MAXKEY)]),
    }
    return {name: torch.from_numpy(v.astype(np.int32)).to(device) for name, v in sets.items()}


def eager_compact_round(key, pt, l_next: int):
    """The compaction round as the port ran it before its kernels: a cummax, a
    cumsum, a searchsorted, two point gathers, a point_add launch at full width
    and two selects."""
    L = key.shape[0]
    is_left = (mk._run_rank(key) & 1) == 0
    next_same = torch.zeros(L, dtype=torch.bool, device=key.device)
    next_same[:-1] = key[1:] == key[:-1]
    has_partner = is_left & next_same
    csum = torch.cumsum(is_left, dim=0)
    wanted = torch.arange(1, l_next + 1, dtype=torch.int64, device=key.device)
    srcpos = torch.searchsorted(csum, wanted).clamp_(max=L - 1)
    valid = wanted <= csum[-1]
    left = dc.gather_pt(pt, srcpos)
    right = dc.gather_pt(pt, (srcpos + 1).clamp_(max=L - 1))
    merged = dc.point_add(left, right)
    out = dc.where_pt(has_partner[srcpos] & valid, merged, left)
    out = dc.where_pt(valid, out, dc.infinity_like((l_next,), key.device))
    new_key = torch.where(valid, key[srcpos], torch.full_like(key[:1], mk.MAXKEY))
    return new_key, out


def eager_horner(per_window, c: int):
    """The window combine as the port ran it before its kernel: a point_double
    launch of c doublings and a point_add launch a window."""
    num_windows = per_window[0].shape[1]
    acc = tuple(v[:, num_windows - 1].contiguous() for v in per_window)
    for w in range(num_windows - 2, -1, -1):
        acc = dc.point_double(acc, times=c)
        acc = dc.point_add(acc, tuple(v[:, w].contiguous() for v in per_window))
    return acc


def round_err(a, b) -> int:
    """The largest word difference of two rounds' (keys, points)."""
    return max(max_abs_err(a[0], b[0]), triple_err(a[1], b[1]))


def plant_neighbours(fq, key, pt, srcpos, count):
    """A copy of ``pt`` whose first survivors that have a partner (and some in
    the middle and at the end) meet the edge cases in turn: equal points (the
    doubling branch), opposite points, the left infinite, the right infinite,
    both infinite."""
    pt = tuple(t.clone() for t in pt)
    n = key.shape[0]
    lefts = srcpos[: int(count)].to(torch.int64)
    right = (lefts + 1).clamp(max=n - 1)
    pairs = lefts[(lefts + 1 < n) & (key[right] == key[lefts])]
    half = pairs.shape[0] // 2
    picks = torch.cat([pairs[:10], pairs[half:half + 5], pairs[-5:]]).tolist()
    for case, i in enumerate(picks):
        kind = case % 5
        if kind == 0:
            for t in pt:
                t[i + 1] = t[i]
        elif kind == 1:
            pt[0][i + 1] = pt[0][i]
            pt[1][i + 1] = fb.sub(fq, torch.zeros_like(pt[1][i]), pt[1][i])
            pt[2][i + 1] = pt[2][i]
        else:
            for lane in ((i,), (i + 1,), (i, i + 1))[kind - 2]:
                pt[2][lane] = 0
    return pt, len(picks)


def check_scan_and_round(rng, pool) -> dict[str, int]:
    """run_scan at every width of SCAN_CHECK_WIDTHS on every key set, with
    l_next below, at and above the survivor count, and compact_add on the same
    rounds over random points (edge neighbours planted; the pool repeated
    above its size, at the survivor count only), word for word: all equal
    keys give tiles of additions only, all distinct keys tiles of copies
    only, a MAXKEY tail tiles of pads."""
    fq = dc.fq_ctx(pool[0].device)
    errs = {"run_scan": 0, "compact_add": 0}
    cases = rounds = planted = 0
    for n in SCAN_CHECK_WIDTHS:
        reps = -(-n // pool[0].shape[0])
        points = tuple(v.repeat(reps, 1)[:n] for v in pool) if reps > 1 else tuple(
            v[:n] for v in pool)
        for name, key in scan_key_sets(rng, n, fq.device).items():
            count = int(mk.run_scan_plain(key, 1)[1])
            for l_next in sorted({max(1, count - 1), count, count + 1}):
                want = mk.run_scan_plain(key, l_next)
                got = mk.run_scan(key, l_next)
                err = max(max_abs_err(g, w) for g, w in zip(got, want))
                check(err == 0, f"run_scan differs from its plain version ({name}, {n} keys, "
                      f"l_next {l_next})")
                errs["run_scan"] = max(errs["run_scan"], err)
                cases += 1
                if n > COMPACT_CHECK_TOP and (l_next != count
                                              or name != "runs across tiles and blocks"):
                    continue
                pt, k = plant_neighbours(fq, key, points, want[0], want[1])
                planted += k
                err = round_err(mk.compact_add(key, pt, *got[:2]),
                                mk.compact_add_plain(key, pt, *want[:2]))
                check(err == 0, f"compact_add differs from its plain version ({name}, {n} keys, "
                      f"l_next {l_next})")
                errs["compact_add"] = max(errs["compact_add"], err)
                rounds += 1
                del pt
        del points
    # again from 1 key up, after the widest launch: each launch now finds the
    # scratch (its tiles' state) larger than it needs and left by a launch
    # over other tiles
    again = 0
    for n in SCAN_CHECK_WIDTHS[:-1]:
        for name, key in scan_key_sets(rng, n, fq.device).items():
            l_next = int(mk.run_scan_plain(key, 1)[1]) + 1
            err = max(max_abs_err(g, w) for g, w in zip(mk.run_scan(key, l_next),
                                                         mk.run_scan_plain(key, l_next)))
            check(err == 0, f"run_scan differs from its plain version ({name}, {n} keys, "
                  f"l_next {l_next}, after wider launches)")
            errs["run_scan"] = max(errs["run_scan"], err)
            again += 1
    torch.cuda.synchronize()
    say(f"  run_scan == its plain version in {cases} cases ({len(SCAN_CHECK_WIDTHS)} widths from 1 "
        f"to {max(SCAN_CHECK_WIDTHS)} keys, five key sets, l_next below, at and above the count) "
        f"and in {again} more from 1 key up after them; compact_add in {rounds} rounds, the same "
        f"keys, {planted} planted neighbours (equal, opposite, infinite)")
    return errs


def quotient_groups(rng, pool, n: int):
    """The window sums of a 2^n-input proof's n quotient steps at their real
    shapes: step k, two segments of 2^(n-1-k) random points and scalars at
    its c; below c = 16 the top HORNER_CHECK_TOP_WINDOWS windows, and
    infinities mixed in: a top window, every third window, a whole segment."""
    groups = []
    for k, c in enumerate(quotient_windows(n)):
        m = 1 << (n - 1 - k)
        scalars = random_scalars(rng, 2 * m, pool[0].device).reshape(2, m, -1)
        per_window = pp._window_sums(tuple(v[:m].contiguous() for v in pool), scalars, c)
        if c < 16:
            per_window = tuple(v[:, -HORNER_CHECK_TOP_WINDOWS:] for v in per_window)
        per_window = tuple(v.contiguous() for v in per_window)
        z = per_window[2]
        if k % 3 == 0:
            z[1, -1] = 0
        elif k % 3 == 1:
            z[0, ::3] = 0
        else:
            z[1] = 0
        groups.append((per_window, c))
    return groups


def check_horner(rng, pool) -> dict[str, int]:
    """horner at HORNER_CHECK_SEGMENTS x HORNER_CHECK_WINDOWS on the per-window
    sums of real MSMs, with infinities mixed in, against its plain version
    (computed at the most segments: the lanes are independent), and
    horner_groups on the quotient steps' shapes at every lanes-a-chain. The
    plain chains of one shape run as one (``horner_groups_plain``)."""
    S = max(HORNER_CHECK_SEGMENTS)
    m = HORNER_CHECK_POINTS
    points = tuple(v[:m].contiguous() for v in pool)
    groups = []
    for c in HORNER_CHECK_WINDOWS:
        scalars = random_scalars(rng, S * m, points[0].device).reshape(S, m, -1)
        per_window = pp._window_sums(points, scalars, c)
        if c < 16:
            per_window = tuple(v[:, -HORNER_CHECK_TOP_WINDOWS:] for v in per_window)
        per_window = tuple(v.contiguous() for v in per_window)
        z = per_window[2]
        z[1, -1] = 0  # segment 1: the top window infinite
        z[2, ::3] = 0  # segment 2: every third window
        z[3] = 0  # segment 3: every window
        groups.append((per_window, c))
    quotients = quotient_groups(rng, pool, GKR_NUM_VARS)
    wants = mk.horner_groups_plain(groups + quotients)
    worst = 0
    for (per_window, c), want in zip(groups, wants):
        for segments in HORNER_CHECK_SEGMENTS:
            got = mk.horner(tuple(v[:segments].contiguous() for v in per_window), c)
            err = triple_err(got, tuple(v[:segments] for v in want))
            check(err == 0, f"horner differs from its plain version ({segments} segments, c={c})")
            worst = max(worst, err)
        check(dc.unpack_points(tuple(v[3:4] for v in want)) == [None], "an all-infinite chain")
    before = mk.launches["horner"]
    got = mk.horner_groups(quotients)
    check(mk.launches["horner"] == before + 1, "horner_groups is not one launch")
    for k, (g, w) in enumerate(zip(got, wants[len(groups):])):
        err = triple_err(g, w)
        check(err == 0, f"horner_groups differs from its plain version (quotient step {k})")
        worst = max(worst, err)
    torch.cuda.synchronize()
    say(f"  horner == its plain version at {HORNER_CHECK_SEGMENTS} segments and c in "
        f"{HORNER_CHECK_WINDOWS} (below 16 the top {HORNER_CHECK_TOP_WINDOWS} windows), on the "
        f"window sums of MSMs of {m} points, infinities mixed in; horner_groups on the "
        f"{GKR_NUM_VARS} quotient steps' shapes (c {quotient_windows(GKR_NUM_VARS)}) in one "
        f"launch")
    return {"horner": worst}


def check_coop_product(rng) -> None:
    """fq_mul_coop (8 lanes a product, as horner runs them) against the oracle on
    2^COOP_CHECK_LOG BLS12-381 Fq values with 0, 1 and p - 1 (phase 15's
    values): edge against edge and each edge against a random value."""
    ctx = fb.get_ctx(BLS12_381_FQ)
    p = ctx.spec.modulus
    a = oracle_values(ctx.spec, rng, 1 << COOP_CHECK_LOG)
    b = oracle_values(ctx.spec, rng, 1 << COOP_CHECK_LOG)
    b = b[1:] + b[:1]
    with ThreadPoolExecutor(os.cpu_count()) as pool:
        want = list(pool.map(lambda x, y: oracle.mul(x, y, p), a, b))
    a_mont = fk.to_mont(ctx, ctx.to_device(ctx.pack(a)))
    b_mont = fk.to_mont(ctx, ctx.to_device(ctx.pack(b)))
    got = fk.from_mont(ctx, mk.fq_mul_coop(a_mont, b_mont))
    values = [int(v) for v in ctx.unpack(got).reshape(-1)]
    bad = sum(x != y for x, y in zip(values, want))
    check(bad == 0, f"fq_mul_coop differs from the oracle in {bad} products")
    say(f"  fq_mul_coop (8 lanes a product) == the oracle on 2^{COOP_CHECK_LOG} BLS12-381 Fq "
        "products, 0, 1 and p - 1 among them")


def check_round(skey, pt, l_next: int, what: str):
    """run_scan and compact_add of one real round against their plain versions
    and the eager round they replace; the round's output."""
    scan = mk.run_scan(skey, l_next)
    check(max(max_abs_err(g, w) for g, w in zip(scan, mk.run_scan_plain(skey, l_next))) == 0,
          f"run_scan differs from its plain version on {what}")
    out = mk.compact_add(skey, pt, *scan[:2])
    check(round_err(out, mk.compact_add_plain(skey, pt, *scan[:2])) == 0,
          f"compact_add differs from its plain version on {what}")
    check(round_err(out, eager_compact_round(skey, pt, l_next)) == 0,
          f"the eager round differs on {what}")
    say(f"  {what}, {skey.shape[0]} keys -> {l_next} slots: run_scan + compact_add == their "
        "plain versions == the eager round")
    return out


def check_horner_chain(per_window, c: int) -> None:
    """horner at one shape, the whole chain, against the eager chain."""
    check(triple_err(mk.horner(per_window, c), eager_horner(per_window, c)) == 0,
          "the eager chain differs")
    say(f"  horner, {per_window[0].shape[0]} segment(s), c = {c}: == the eager chain "
        f"({2 * (per_window[0].shape[1] - 1)} launches)")


def phase_msm_kernels(gctx, inputs, taus) -> dict[str, int]:
    """run_scan, compact_add and horner against their plain versions, word for
    word, and the cooperative lanes' product against the oracle; then, at the
    KZG path's real widths, the commitment MSM's first compaction round (2^24
    keys) and a steady one, and whole Horner chains, against the eager chains
    the kernels replace."""
    rng = np.random.default_rng(18)
    check_coop_product(rng)
    pool = random_points(rng, COMPACT_CHECK_TOP, gctx.device)
    errs = check_scan_and_round(rng, pool)
    errs.update(check_horner(rng, pool))
    del pool
    torch.cuda.empty_cache()

    # the commitment MSM of phase 8: its presorted lanes and first rounds
    input_poly = MultilinearPoly.from_ints(gctx, inputs)
    basis = KZG.for_poly(input_poly, taus).g1_lagrange_basis
    scalars = fk.from_mont(gctx, input_poly.table)
    n = scalars.shape[0]
    c = pp.pick_window_bits(n)
    nbuck = (1 << (c - 1)) + 1
    fq = dc.fq_ctx(basis[0].device)
    abs_d, signs = pp._recode_signed(scalars, c)
    skey, pt = pp._presort(basis, fb.sub(fq, torch.zeros_like(basis[1]), basis[1]), abs_d, signs,
                           nbuck)
    sizes = pp._compaction_schedule(skey.shape[0], 256 // c * nbuck + 1)
    skey, pt = check_round(skey, pt, sizes[0], "the commitment's first round")
    for l_next in sizes[1:]:
        skey, pt = pp._compact_round(skey, pt, l_next)
    check_round(skey, pt, sizes[-1], "a steady round of the commitment")
    del skey, pt, abs_d, signs
    torch.cuda.empty_cache()

    per_window = pp._window_sums(basis, scalars[None], c)
    check_horner_chain(tuple(v.contiguous() for v in per_window), c)
    for segments, cc in HORNER_EAGER_SHAPES:
        m = min(1 << 10, n)
        sc = random_scalars(rng, segments * m, basis[0].device).reshape(segments, m, -1)
        pw = pp._window_sums(tuple(v[:m].contiguous() for v in basis), sc, cc)
        check_horner_chain(tuple(v.contiguous() for v in pw), cc)
    return errs


# ----------------------------------------------------------------------
# phase 19: the fused GKR phase kernels
# ----------------------------------------------------------------------

#: gkr_big_round against its plain version on stacks of 2^15 to 2^20 entries
#: (a phase's first round and a steady one, every trim)
BIG_ROUND_LOGS = tuple(range(15, 21))
#: pending tails of the first rounds checked: 8 lanes keep 0-2 coefficients in
#: one block and carry 3 into two, 16 carry 1-3 and leave 0 in one
PHASE_TAIL_LANES = (8, 16)
#: sizes at which gkr_phase_tail is checked at every trim, the others taking
#: one trim each in turn
TAIL_ALL_TRIMS_LOGS = (1, 2, 3)
#: gkr_phase_tail is also held at these forced ``gk.BLOCK_MAX`` on stacks of up
#: to 2^TAIL_FORCED_LOG entries: grid rounds only (1), and the switch from grid
#: rounds (of several blocks, whose number shrinks) to block rounds at other
#: sizes
TAIL_FORCED_BLOCK_MAX = (1, 4, 1 << 9, 1 << 10)
TAIL_FORCED_LOG = 12


def phase_stack(ctx, rng, size: int, trim: int):
    """A (2, 2, size, W) stack on the card whose rounds trim to ``trim``
    coefficients: 0 all zero; 1 every table constant; 2 the factor-1 tables
    constant (each term linear in t); 3 random, p - 1 and 1 among its entries."""
    if trim == 0:
        return torch.zeros((2, 2, size, ctx.num_words), dtype=torch.int32, device=ctx.device)
    if trim == 3:
        return random_table(ctx, rng, 2, 2, size, edges=(ctx.spec.modulus - 1, 1))
    stack = random_table(ctx, rng, 2, 2, size)
    if trim == 1:
        stack[:] = stack[:, :, :1].clone()
    else:
        stack[:, 1] = stack[:, 1, :1].clone()
    return stack


def phase_round_inputs(ctx, rng, size: int, trim: int, first: bool, tail_lanes: int):
    """(stack, challenge or None, state, pending tail or None) of a round or a
    tail: a phase's first round continues a random sponge after a random tail,
    a steady one folds at a random challenge first."""
    stack = phase_stack(ctx, rng, size, trim)
    state = random_lanes(rng, 25, ctx.device)
    if first:
        return stack, None, state, random_lanes(rng, tail_lanes, ctx.device)
    return stack, random_table(ctx, rng), state, None


def phase_err(got, want) -> int:
    """The largest word difference of two results of a phase kernel."""
    return max(lane_err(g, w) if g.dtype == torch.int64 else max_abs_err(g, w)
               for g, w in zip(got, want))


def phase_gkr_phase_kernels(gctx) -> dict[str, int]:
    """gkr_big_round and gkr_phase_tail against their plain versions, word for
    word."""
    rng = np.random.default_rng(19)
    errs = {name: 0 for name in gk.KERNEL_NAMES}
    lib = gk.library()
    say(f"  gkr_phase_tail's grid: at most {gk._resident(lib, gctx.device)} blocks "
        f"(resident, cooperative), one where its first round sums at most BLOCK_MAX "
        f"{gk.BLOCK_MAX} entries a table; gkr_big_round's at most {gk.MAX_BIG_BLOCKS}; "
        f"TAIL_MAX {fused_lazy.TAIL_MAX}")
    checked = 0
    for log in BIG_ROUND_LOGS:
        for trim in range(4):
            for first in (True, False):
                args = phase_round_inputs(gctx, rng, 1 << log, trim, first,
                                          PHASE_TAIL_LANES[trim % 2])
                err = phase_err(gk.gkr_big_round(gctx, *args), gk.gkr_big_round_plain(gctx, *args))
                check(err == 0, f"gkr_big_round differs from its plain version at 2^{log}, "
                      f"trim {trim}, {'first' if first else 'steady'}")
                errs["gkr_big_round"] = max(errs["gkr_big_round"], err)
                checked += 1
        torch.cuda.empty_cache()
    # back to back at other widths: the ticket the last block resets
    wide = phase_round_inputs(gctx, rng, 1 << 20, 3, False, 0)
    narrow = phase_round_inputs(gctx, rng, 1 << 15, 3, False, 0)
    want_wide = gk.gkr_big_round_plain(gctx, *wide)
    for args, want in ((wide, want_wide), (narrow, gk.gkr_big_round_plain(gctx, *narrow)),
                       (wide, want_wide)):
        check(phase_err(gk.gkr_big_round(gctx, *args), want) == 0,
              "gkr_big_round differs from its plain version back to back")
    del wide, narrow, want_wide
    say(f"  gkr_big_round: {checked} rounds of 2^{BIG_ROUND_LOGS[0]}-2^{BIG_ROUND_LOGS[-1]} "
        f"entries (first and steady, trims 0-3) and 3 back to back at 2^20 / 2^15 / 2^20: max "
        f"error {errs['gkr_big_round']}")
    tail_max_log = fused_lazy.TAIL_MAX.bit_length() - 1
    checked = forced = 0
    for log in range(1, tail_max_log + 1):
        all_trims = log in TAIL_ALL_TRIMS_LOGS
        for first in (True, False):
            trims = range(4) if all_trims else ((log + first) % 4,)
            for trim in trims:
                # a steady tail starts with the fold of twice its first table
                size = 1 << log if first else 1 << (log + 1)
                args = phase_round_inputs(gctx, rng, size, trim, first,
                                          PHASE_TAIL_LANES[(log + trim) % 2])
                got = gk.gkr_phase_tail(gctx, *args)
                want = gk.gkr_phase_tail_plain(gctx, *args)
                err = phase_err(got, want)
                check(err == 0, f"gkr_phase_tail differs from its plain version at 2^{log}, "
                      f"trim {trim}, {'first' if first else 'after a fold'}")
                check({tk.trim_len(rows) for rows in want[0]} == {trim},
                      f"the tables of trim {trim} at 2^{log} trim otherwise")
                errs["gkr_phase_tail"] = max(errs["gkr_phase_tail"], err)
                checked += 1
                if log > TAIL_FORCED_LOG or trim != trims[-1]:
                    continue
                kept = gk.BLOCK_MAX
                try:
                    for block_max in TAIL_FORCED_BLOCK_MAX:
                        gk.BLOCK_MAX = block_max
                        err = phase_err(gk.gkr_phase_tail(gctx, *args), want)
                        check(err == 0, f"gkr_phase_tail differs from its plain version at "
                              f"2^{log}, {'first' if first else 'after a fold'}, BLOCK_MAX "
                              f"{block_max}")
                        errs["gkr_phase_tail"] = max(errs["gkr_phase_tail"], err)
                        forced += 1
                finally:
                    gk.BLOCK_MAX = kept
    say(f"  gkr_phase_tail: {checked} tails from every size 2-2^{tail_max_log}, first and after "
        f"a fold, trims 0-3, pending tails of {PHASE_TAIL_LANES} lanes, BLOCK_MAX "
        f"{gk.BLOCK_MAX}; {forced} more up to 2^{TAIL_FORCED_LOG} at BLOCK_MAX "
        f"{TAIL_FORCED_BLOCK_MAX}: max error {errs['gkr_phase_tail']}")
    return errs


# ----------------------------------------------------------------------
# phase 20: the GKR layer-table kernels
# ----------------------------------------------------------------------

def words_differ(a, b) -> int:
    """Mismatched 32-bit words of two equal-shape tables (all of them when the
    shapes differ)."""
    if a.shape != b.shape:
        return max(a.numel(), b.numel())
    return int((a != b).sum().item())


def table_inputs(ctx, rng, log: int):
    """A layer of 2^log gates, mixed types, as the walk's tables take it: the
    wiring's (2, k, W) challenges with 0, 1 and p - 1 among them and its two
    scales; w (2n, W); phase 1's log + 1 challenges with p - 1 and 0; w(r_b)."""
    n, k, p = 1 << log, max(1, log), ctx.spec.modulus
    is_add = torch.from_numpy(rng.integers(2, size=n).astype(bool)).to(ctx.device)
    vals = [int.from_bytes(rng.bytes(40), "little") % p for _ in range(2 * k)]
    vals[: min(3, 2 * k)] = [0, 1, p - 1][: min(3, 2 * k)]
    challenges = gkr_lazy._encode(ctx, vals).reshape(2, k, ctx.num_words)
    scales = gkr_lazy._encode(ctx, [int.from_bytes(rng.bytes(40), "little") % p for _ in range(2)])
    w = random_table(ctx, rng, 2 * n)
    r_vals = [int.from_bytes(rng.bytes(40), "little") % p for _ in range(log + 1)]
    r_vals[-1] = p - 1
    if log:
        r_vals[0] = 0
    return (n, is_add, challenges, scales, w, gkr_lazy._encode(ctx, r_vals),
            random_table(ctx, rng, 1)[0])


def phase_gkr_tables_kernels(gctx) -> None:
    """gkr_wiring, gkr_phase1_stack and gkr_phase2_stack against their plain
    versions (the eager chains they replace), word for word, at every layer
    size of the 2^GKR_NUM_VARS-input walk (2^0 to 2^(GKR_NUM_VARS - 1) gates;
    the wiring also as the output layer's one unscaled term at 1 and 2 gates,
    the stacks also on the plain coefficients)."""
    rng = np.random.default_rng(20)
    errs = {name: 0 for name in gt.KERNEL_NAMES}
    gt.reset_launches()
    for log in range(GKR_NUM_VARS):
        n, is_add, challenges, scales, w, r_b, wb = table_inputs(gctx, rng, log)
        got = gt.wiring_coefs(gctx, challenges, scales, is_add, n)
        want = gt.wiring_coefs_plain(gctx, challenges, scales, is_add, n)
        errs["gkr_wiring"] += words_differ(got[0], want[0]) + words_differ(got[1], want[1])
        if n <= 2:
            one = challenges[:1, :1].contiguous()
            out = gt.wiring_coefs(gctx, one, None, is_add, n)
            ref = gt.wiring_coefs_plain(gctx, one, None, is_add, n)
            errs["gkr_wiring"] += words_differ(out[0], ref[0]) + words_differ(out[1], ref[1])
        for coef_a, coef_m in (got, want):
            errs["gkr_phase1_stack"] += words_differ(
                gt.phase1_stack(gctx, coef_a, coef_m, w),
                gt.phase1_stack_plain(gctx, coef_a, coef_m, w))
            errs["gkr_phase2_stack"] += words_differ(
                gt.phase2_stack(gctx, coef_a, coef_m, w, r_b, wb),
                gt.phase2_stack_plain(gctx, coef_a, coef_m, w, r_b, wb))
        del got, want, w
        torch.cuda.empty_cache()
    for name in gt.KERNEL_NAMES:
        check(errs[name] == 0, f"{name} differs from its plain version in {errs[name]} words")
    want_launches = {"gkr_wiring": GKR_NUM_VARS + 2, "gkr_phase1_stack": 2 * GKR_NUM_VARS,
                     "gkr_phase2_stack": 2 * GKR_NUM_VARS}
    check(gt.launches == want_launches, f"table launches {gt.launches} != {want_launches}")
    say(f"  gkr_wiring, gkr_phase1_stack, gkr_phase2_stack at 2^0-2^{GKR_NUM_VARS - 1} gates "
        f"(mixed types, challenges 0, 1, p - 1 among them; the output layer's one term at 1 "
        f"and 2 gates): mismatched words {errs}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    t_start = time.time()
    gpu = gpu_line()
    say(f"[1] device: {gpu}")
    say(f"    torch {torch.__version__}, CUDA {torch.version.cuda}")
    _build.build_cuda_libraries(list(CUDA_STEMS))
    fk.library()
    pk.library()
    nk.library()
    tk.library()
    mk.library()
    gk.library()
    say(f"    kernels built from {KERNEL_SOURCE}, {POINT_KERNEL_SOURCE}, {NTT_KERNEL_SOURCE}, "
        f"{TRANSCRIPT_KERNEL_SOURCE}, {MSM_KERNEL_SOURCE} and {GKR_PHASE_KERNEL_SOURCE}, side by side")
    for stem, needles in (("sumcheck_kernels", ("gkr_round_kernel", "halves_sums_kernel",
                                                "fold_and_halves_kernel")),
                          ("point_kernels", ("point_add_kernel", "point_double_kernel")),
                          ("ntt_kernels", ("ntt_phase1_kernel", "ntt_stage_kernel")),
                          ("transcript_kernels", ("keccak_f_kernel", "round_step_kernel")),
                          ("msm_kernels", tuple(f"{name}_kernel" for name in SCAN_PASSES)
                           + ("compact_add_kernel", "horner_kernel", "fq_mul_coop_kernel")),
                          ("gkr_phase_kernels", ("gkr_big_round_kernel", "gkr_phase_tail_kernel"))):
        for needle in needles:
            for line in resource_usage(_build.build_log[stem], needle):
                say(f"    {line}")
                if stem != "sumcheck_kernels" or "<W=8>" in line:  # W = 12: no path runs it
                    check("0 bytes spill stores" in line, f"{line.split(':')[0]} spills registers")
                if needle == "round_step_kernel":
                    check("0 bytes stack frame" in line, f"{line.split(':')[0]} has a stack frame")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lib = fk.library()
    for name in fk._SUMMING:
        for w in (8, 12):
            n = fk._resident_blocks(lib, torch.device("cuda"), name, w)
            threads = (lib.zk_block_threads() if name == "gkr_round"
                       else lib.zk_sum_threads(fk._SUMMING[name], w))
            say(f"    {name} W = {w}: {threads} threads a block, {n} resident blocks "
                f"({n / sms:g} an SM)")
    say(f"    host Keccak backend: {hk.backend()}")
    check(hk.backend() == "c", "the host Keccak fell back to pure Python")

    say("[2] each kernel against its plain PyTorch version (exact)")
    errs = phase_kernels_vs_plain()
    for name, err in phase_sum_kernels_vs_plain().items():
        errs[name] = max(errs[name], err)
    errs.update(phase_point_kernels_vs_plain())

    ctx = fb.get_ctx(BN254_FQ)
    say(f"[3] main path: 2^{NUM_VARS} BN254 Fq sumcheck, from_ints -> fused.prove -> verify")
    poly, proof, launches = phase_main_path(ctx)

    say("[4] the tie to the reference")
    phase_reference_tie(ctx, poly, proof)

    del poly
    torch.cuda.empty_cache()
    gctx = fb.get_ctx(BLS12_381_FR)
    say(f"[5] GKR path: 2^{GKR_NUM_VARS} inputs over BLS12-381 Fr, "
        "Circuit.evaluate -> prove_layers -> verify_layers")
    circuit, inputs, proved, gkr_launches = phase_gkr_main_path(gctx)

    say("[6] the GKR proof's ties")
    phase_gkr_ties(gctx)

    torch.cuda.empty_cache()
    say(f"[8] KZG path: the whole proof of the same 2^{GKR_NUM_VARS}-input circuit, "
        "gkr.protocol.prove -> gkr.protocol.verify")
    full_proof, taus, kzg_launches = phase_kzg_main_path(gctx, circuit, inputs, gkr_launches)

    say("[9] the input proof's ties")
    phase_kzg_ties(gctx, inputs, full_proof, taus, proved)
    # phase 15 decodes this blob; of the proof it keeps what the host holds
    gkr_blob = ser.encode_gkr_proof(full_proof)
    kept = tampered(full_proof, kzg_setup=KZG(None, full_proof.input_proof.kzg_setup.g2_taus,
                                              GKR_NUM_VARS))
    del full_proof
    torch.cuda.empty_cache()

    say("[11] the two NTT kernels against their plain PyTorch versions (exact)")
    errs.update(phase_ntt_kernels_vs_plain())
    rctx = fb.get_ctx(BN254_FR)
    say(f"[12] NTT path: BN254 Fr, ntt forward and inverse at 2^{NTT_LOG_SIZES[0]} and "
        f"2^{NTT_LOG_SIZES[1]}, fft_evaluate -> fft_interpolate at 2^{NTT_LOG_SIZES[0]}")
    ntt_results, ntt_poly, ntt_evals, ntt_interp, ntt_launches = phase_ntt_main_path(rctx)
    phase_ntt_ties(rctx, ntt_results, ntt_poly, ntt_evals, ntt_interp)
    ntt_inputs = {log_n: r[0] for log_n, r in ntt_results.items()}
    ntt_outputs = {log_n: (r[0], r[2]) for log_n, r in ntt_results.items()}
    del ntt_results, ntt_evals, ntt_interp
    torch.cuda.empty_cache()
    phase_device_kernels(ctx, gctx)
    say("[14] each path once more under torch.profiler: one device kernel a launch")
    scan_op_kernels()
    profiles = phase_profiles(ctx, gctx, rctx, circuit, inputs, taus, ntt_inputs, ntt_poly)
    check_one_launch(profiles)

    say("[15] proof bytes and the field oracle")
    reset_all_launches()
    phase_oracle()
    phase_proof_bytes(proof, gkr_blob, kept, circuit, proved)
    bytes_launches = all_launches()
    say(f"  launches in phase 15: {bytes_launches}")

    say("[16] the mesh paths: one-process meshes of card slots")
    errs.update({name: max(errs[name], err)
                 for name, err in phase_batched_ntt_kernels_vs_plain().items()})
    mesh_launches = phase_mesh_paths(ctx, gctx, rctx, proof, circuit, inputs, taus, gkr_blob,
                                     kept.input_proof.commitment, ntt_outputs)
    say(f"  launches in phase 16: {mesh_launches}")
    for name in nk.KERNEL_NAMES + mk.KERNEL_NAMES + ("mont_mul", "fold", "halves_sums",
                                                     "gkr_round", "point_add", "point_double"):
        check(mesh_launches[name] > 0, f"the mesh paths launched no {name}")

    say("[17] the transcript kernels, keccak_f and round_step, against their plain PyTorch "
        "versions (exact)")
    errs.update(phase_transcript_kernels())

    say("[18] the MSM kernels, run_scan, compact_add and horner, against their plain PyTorch "
        "versions (exact), and at the KZG path's widths against the eager chains they replace")
    errs.update(phase_msm_kernels(gctx, inputs, taus))

    say("[19] the fused GKR phase kernels, gkr_big_round and gkr_phase_tail, against their "
        "plain PyTorch versions (exact)")
    errs.update(phase_gkr_phase_kernels(gctx))

    say("[20] the GKR layer-table kernels, gkr_wiring, gkr_phase1_stack and gkr_phase2_stack, "
        "against their plain PyTorch versions (exact)")
    phase_gkr_tables_kernels(gctx)

    sources = {KERNEL_SOURCE: fk, POINT_KERNEL_SOURCE: pk, NTT_KERNEL_SOURCE: nk,
               TRANSCRIPT_KERNEL_SOURCE: tk, MSM_KERNEL_SOURCE: mk, GKR_PHASE_KERNEL_SOURCE: gk}
    kernels = [{
        "name": name, "route": "cuda", "source": source, "replaces": REPLACES[name],
        "launches": (launches.get(name, 0) + gkr_launches.get(name, 0) + kzg_launches[name]
                     + ntt_launches[name] + bytes_launches[name] + mesh_launches[name]),
        "max_abs_err": errs[name],
    } for source, module in sources.items() for name in module.KERNEL_NAMES]
    say(f"chip_smoke: {checks_run} checks passed in {time.time() - t_start:.1f}s")
    say(gpu)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "checks": checks_run, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

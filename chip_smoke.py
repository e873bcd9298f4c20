#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``zktpu_torch``): run it on one GPU.

    python3 chip_smoke.py

It needs one CUDA device and ``nvcc``; with no card it exits non-zero at once.
It builds the CUDA kernels from ``zktpu_torch/csrc/`` (one ``nvcc`` a source, all
started together), then

  1. prints the card's name and power limit, the build time and the host Keccak
     backend (the pure-Python one is refused);
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
     ``sumcheck.protocol.verify``), and reads the kernels' launch counts;
  4. ties the proof to the JAX reference package: it must equal the host-loop
     prover's, hash to a stored digest, and a 2^12 proof must equal the CPU's;
     a tampered proof must be refused;
  5. drives the second main path at full size: the GKR layer walk of a halving
     circuit of 2^20 inputs and 2^20 - 1 random add/mul gates over BLS12-381 Fr
     (``Circuit.evaluate`` -> ``gkr.protocol.prove_layers``, lazy and fused by
     default -> ``gkr.protocol.verify_layers``), reads the launch counts again,
     and checks the input layer's two evaluations and two tampered proofs;
  6. ties the GKR proof: the fused proof equals the host-loop lazy one at 2^20
     inputs, the dense one equals the lazy one at 2^8, the card's equals the
     CPU's at 2^10, and the 2^16 proof hashes to a stored digest;
  7. times the first two paths and each kernel (CUDA events, median), beside
     each kernel's plain version and the least time the card could take
     (gkr_round, halves_sums and fold_and_halves beside their times before
     the redesign; halves_sums beside a torch.sum of the same bytes);
  8. drives the third main path at full size: the whole GKR proof of the same
     2^20-input circuit with its multilinear-KZG input proof
     (``gkr.protocol.prove`` -> ``gkr.protocol.verify``: the SRS comb, the
     Pippenger MSMs of the commitment and of the 2 x 20 quotients, the host's
     pairings), reads the launch counts of the kernels (a compaction round is
     one run_scan and one compact_add launch, 171 in all; a Horner chain one
     horner launch, 21; no point_double), and refuses a tampered quotient
     point, commitment and opened evaluation;
  9. ties the input proof without a reference run: the taus are known, so the
     commitment, every quotient commitment and some SRS entries must be the
     host's scalar multiples of G1; the comb equals the ladder and Pippenger the
     bit-split MSM at 2^10; a 2^6 proof on the card equals the CPU's; the 2^5
     proof hashes to a stored digest;
 10. times the third path: ``prove`` warm with its stages and each quotient
     step, ``verify`` with the host's pairings apart, synchronising calls, peak
     device memory; then the point kernels at 2^16 and 2^20 beside their
     times before the redesign, at widths 1 and 2 (the Horner chain's shapes,
     point_double 1, 4, 8 and 16 times) and on a 2^20 batch that is 75 %
     infinities;
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
     against the CPU's;
 13. times both NTT kernels at 2^20 and 2^22 beside their plain versions and
     bounds (ntt_phase1 beside its time before the redesign), the twiddle
     build, warm transforms, and ``fft_evaluate`` /
     ``fft_interpolate`` with their host packing apart.

Before (14), the profiler counts the device kernels of phase 4's fused prove
(at most 3 a round + 10) and of one of phase 7's fused GKR rounds (at most 5).
Then (14) each of the four paths runs once more under ``torch.profiler``, and
the fourteen kernels are ranked by their device time on the paths less the
bound of the lanes they covered there; on each path the device runs one kernel
a launch of ``halves_sums``, ``fold_and_halves``, ``round_step``, ``keccak_f``,
``compact_add`` and ``horner``, three of ``run_scan``, a ``round_step`` a round,
no ``keccak_f``, a ``finish_rows`` only after ``gkr_round`` (none on the
sumcheck path), and no device kernel of ``torch.cummax`` or
``torch.searchsorted`` (named as a profile of each op on the card shows them),
or the script fails. Last,

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
     word, and their times beside the unbatched table's; then, on a mesh of 4
     slots of the one card and on the mesh of every card present:
     ``sumcheck_prove_sharded`` of phase 3's table equals phase 3's proof and
     digest; ``ntt_sharded`` forward and inverse at 2^20 and 2^22 equals phase
     12's outputs and inputs; ``msm_pippenger_sharded`` and the ladder
     ``msm_sharded`` (the path that runs ``point_double``) of the 2^20-point
     commitment equal phase 8's commitment; on the 4-slot mesh
     ``gkr.prove(mesh=...)`` of phase 8's circuit encodes to phase 8's bytes
     (phase 15's blob), and once more under the profiler it runs no cummax or
     searchsorted kernel and one device kernel a launch of the MSM kernels;
     ``dryrun_multichip`` passes; the launches of each kernel in the phase and
     each sharded path's warm time beside the single device's.
 17. the transcript kernels: ``keccak_f`` against its plain version on 1, 33
     and 4096 random states, ``round_step`` on 2 and 3 lazy rows (trimmed
     lengths 0-3, steady rounds and first rounds of one and two blocks, low
     words at or above p, digests at or above p) for BN254 Fq and BLS12-381 Fr,
     word for word; each one's device time a launch at the paths' shapes (by
     the profiler's clock) beside its plain version, its bound and one
     thread's least time.
 18. the MSM kernels: ``run_scan`` against its plain version at 1, 2, 3 and
     from 127 to 2^24 keys (random runs, all equal, all distinct, runs that
     cross the scan's tiles and blocks, MAXKEY tails; ``l_next`` below, at and
     above the survivor count), ``compact_add`` up to 2^20 keys with equal,
     opposite and infinite neighbours planted, ``horner`` at 1, 2 and 4
     segments and c = 4, 8 (the top 8 windows), 16 (all) on the window sums
     of real MSMs with infinities mixed in, word for word; then on the commitment MSM of phase
     8, its first compaction round (2^24 keys) and a steady one, and its
     Horner chain: each kernel against its plain version and the eager chain
     it replaced, with their times (CUDA events) beside the bounds, and the
     quotient steps' Horner shapes.

The bounds are ``zktpu_torch/utils/roofline.py``'s, at the peaks it lists for
the card (it raises on a card it does not list). Any failed comparison exits
non-zero. The last line of the output is one JSON object, ``{"ok": true,
"device": {...}}``; the line before it lists the fourteen kernels with their
launch counts (the four paths and phases 15 and 16), errors, times and bounds.
The fused provers' transcript is ``round_step``'s: phases 3 and 5 count a
launch a round, and no ``mont_mul`` or permutation of their own.
"""

from __future__ import annotations

import copy
import json
import os
import re
import statistics
import struct
import subprocess
import sys
import time
import warnings
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
from zktpu_torch.gkr import lazy as gkr_lazy
from zktpu_torch.gkr import protocol as gkr
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
from zktpu_torch.utils import roofline
from zktpu_torch.utils.roofline import time_events

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
POINT_TIME_WIDTHS = (1 << 16, 1 << 20)
#: the Horner chain's widths, and the repeat counts timed there
HORNER_WIDTHS = (1, 2)
HORNER_TIMES = (1, 4, 8, 16)
#: the point kernels' times before the redesign (ms, CUDA events, L2 flushed;
#: chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md section 6)
POINT_MS_BEFORE = {("point_add", 1 << 16): 0.1848, ("point_add", 1 << 20): 1.4642,
                   ("point_double", 1 << 16): 0.0478, ("point_double", 1 << 20): 0.5428}
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
TIME_SIZES = (1 << 20, 1 << 24)
TIMED_RUNS = 10

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

#: the times of gkr_round, halves_sums and fold_and_halves (at 2^20 and 2^24
#: entries) and ntt_phase1 (at 2^20 and 2^22) before their redesign (ms, CUDA
#: events, L2 flushed; chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W,
#: PERF.md section 6)
KERNEL_MS_BEFORE = {("gkr_round", 1 << 20): 0.1417, ("gkr_round", 1 << 24): 1.8577,
                    ("halves_sums", 1 << 20): 0.0283, ("halves_sums", 1 << 24): 0.1927,
                    ("fold_and_halves", 1 << 20): 0.0370,
                    ("fold_and_halves", 1 << 24): 0.3453,
                    ("ntt_phase1", 1 << 20): 0.2310, ("ntt_phase1", 1 << 22): 0.8480}

#: phase 16: the batched NTT kernels against their plain versions, word for
#: word, at these (log2 entries of a table, tables in the batch): the row DFTs
#: of the four-step NTT at 2^20 and 2^22, three rows of 2^12, rows of 1, 2, 4
NTT_BATCH_CHECKS = ((10, 1 << 10), (11, 1 << 11), (12, 3), (0, 5), (1, 5), (2, 5))
#: the slots of the one-card mesh of phase 16 (the card repeated), and the
#: runs of each sharded path's warm time
MESH_SLOTS = 4
MESH_TIMED_RUNS = 3

KERNEL_SOURCE = "zktpu_torch/csrc/sumcheck_kernels.cu"
POINT_KERNEL_SOURCE = "zktpu_torch/csrc/point_kernels.cu"
NTT_KERNEL_SOURCE = "zktpu_torch/csrc/ntt_kernels.cu"
TRANSCRIPT_KERNEL_SOURCE = "zktpu_torch/csrc/transcript_kernels.cu"
MSM_KERNEL_SOURCE = "zktpu_torch/csrc/msm_kernels.cu"
#: the kernel sources, one nvcc each, all started together
CUDA_STEMS = ("sumcheck_kernels", "point_kernels", "ntt_kernels", "transcript_kernels",
              "msm_kernels")
#: the TPU kernel each replaces; the transcript and MSM kernels replace zktpu's
#: device programs (XLA, not Pallas): keccak_f the permutation, round_step the
#: round of gkr/fused_lazy.py:_big_round and of sumcheck/fused.py:_device_prove
#: (:192); run_scan the scan of msm/pippenger.py:_compact_round and _max_run
#: (:295), compact_add the rest of that round (its gathers, point_add_px at :180
#: and its selects), horner the window combine _horner_multi
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


def gkr_expected_launches(n: int) -> dict[str, int]:
    """Launches of ``prove_layers`` (lazy, fused) + ``verify_layers`` (lazy) on a
    halving circuit of 2^n inputs. The layer whose inputs have j variables
    (j = 1..n) runs 2j rounds.

    gkr_round and round_step: one a round, n(n+1) in all; the round's canonical
    form, interpolation, absorb and challenge are round_step's, so a round makes
    no mont_mul and no keccak_f.
    fold: one a round; j for each of the layer's two input evaluations; one for
    the output polynomial's evaluation, in the prover and again in the verifier.
    mont_mul, prover: a layer makes 2 + 3 for the phase tables, 2 for the gate
    masks, 2j for eq(r_b, .), 1 for the challenges' upload, 4(j-1) + 2 + 1 for
    the folded wiring coefficients (3 at the output layer) and 4 for the two
    evaluations: 6j + 11, that is 3 a round + 11; the walk adds 1 for the inputs,
    n for the circuit, 3 for the output polynomial.
    mont_mul, verifier: a layer makes 4(j-1) + 5 for the coefficients (5 at the
    output layer), 4j + 1 for the two eq tables, 3 for the weights, 1 for the
    two sums: 8j + 6; the walk adds 2 for the output polynomial.
    """
    rounds = n * (n + 1)
    prover_mul = 3 * rounds + 11 * n + 1 + n + 3
    verifier_mul = 4 * rounds + 6 * n + 2
    return {
        "mont_mul": prover_mul + verifier_mul,
        "fold": rounds + rounds + 1 + 1,
        "gkr_round": rounds,
        "halves_sums": 0,
        "fold_and_halves": 0,
        "round_step": rounds,
        "keccak_f": 0,
    }


def say(msg: str) -> None:
    print(msg, flush=True)


def check(cond, msg: str) -> None:
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


def gkr_proof_digest(spec, layers_proof) -> str:
    return hk.keccak256(vec_to_bytes(spec, gkr_proof_values(layers_proof))).hex()


def resource_usage(log: str, needle: str) -> list[str]:
    """What ``nvcc --resource-usage`` printed for the kernels whose mangled name
    holds ``needle``: the template's word count where it has one, then ptxas's
    own two lines."""
    lines = log.splitlines()
    out = []
    for i, line in enumerate(lines):
        if "Function properties for" in line and needle in line:
            label = needle
            if needle + "ILi" in line:
                label += "<W=" + line.split(needle + "ILi")[1].split("E")[0] + ">"
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
    t0 = time.time()
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
    say(f"  (these checks took {time.time() - t0:.1f}s)")
    return worst


# ----------------------------------------------------------------------
# phases 3 and 4: the main path and its tie to the reference
# ----------------------------------------------------------------------

def phase_main_path(ctx):
    values = benchmark_values(NUM_VARS)
    torch.cuda.synchronize()
    fk.reset_launches()
    tk.reset_launches()
    t0 = time.time()
    poly = MultilinearPoly.from_ints(ctx, values)
    torch.cuda.synchronize()
    t_build = time.time() - t0
    t0 = time.time()
    proof = fused.prove(poly)
    torch.cuda.synchronize()
    t_prove = time.time() - t0
    t0 = time.time()
    ok = protocol.verify(poly, proof)
    torch.cuda.synchronize()
    t_verify = time.time() - t0
    launches = {**fk.launches, **tk.launches}
    say(f"  first run: table build+upload {t_build:.3f}s  prove {t_prove:.3f}s "
        f"(includes the host's Keccak pass over the table)  verify {t_verify:.3f}s")
    say(f"  launches on the main path: {launches}")
    check(ok, "verify refused the fused prover's proof")
    check(len(proof.proof_polynomials) == NUM_VARS, "wrong number of round polynomials")
    p = ctx.spec.modulus
    check(all(0 <= v < p for rp in proof.proof_polynomials for v in rp), "values not canonical")
    check(proof.claimed_sum == sum(values) % p, "claimed sum is not the table's sum")
    check(launches == EXPECTED_LAUNCHES, f"launch counts {launches} != {EXPECTED_LAUNCHES}")
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
    torch.cuda.synchronize()
    t0 = time.time()
    input_poly = MultilinearPoly.from_ints(ctx, inputs)
    torch.cuda.synchronize()
    t_upload = time.time() - t0
    t0 = time.time()
    evaluations = circuit.evaluate(input_poly)
    torch.cuda.synchronize()
    t_eval = time.time() - t0
    check(len(evaluations) == n and evaluations[-1].table.shape[0] == 1, "circuit evaluation shape")

    fk.reset_launches()
    tk.reset_launches()
    t0 = time.time()
    proved = gkr.prove_layers(circuit, inputs)
    torch.cuda.synchronize()
    t_prove = time.time() - t0
    t0 = time.time()
    verdict = gkr.verify_layers(proved.proof, circuit, proved.input_evals)
    torch.cuda.synchronize()
    t_verify = time.time() - t0
    launches = {**fk.launches, **tk.launches}
    say(f"  first run: inputs upload {t_upload:.3f}s  circuit evaluation {t_eval:.3f}s  "
        f"prove_layers {t_prove:.3f}s (uploads and evaluates again)  verify_layers {t_verify:.3f}s")
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
    return circuit, inputs, proved, launches


def same_layers_proof(a, b) -> bool:
    return gkr_proof_values(a) == gkr_proof_values(b)


def phase_gkr_ties(ctx, circuit, inputs, proved) -> None:
    t0 = time.time()
    host_loop = gkr.prove_layers(circuit, inputs, fused=False)
    torch.cuda.synchronize()
    check(same_layers_proof(host_loop, proved), "fused proof differs from the host-loop lazy prover's")
    say(f"  fused proof == host-loop lazy proof at 2^{GKR_NUM_VARS} inputs "
        f"(host loop {time.time() - t0:.1f}s)")

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
# phase 7: times
# ----------------------------------------------------------------------

def time_kernels_at(ctx, rng, flush, r, size: int) -> dict[str, dict]:
    table = random_table(ctx, rng, size)
    gctx = fb.get_ctx(BLS12_381_FR)  # the field of the path that launches gkr_round
    stack = random_table(gctx, rng, 2, 2, size)
    cases = {
        "mont_mul": (lambda: fk.mont_mul(ctx, table, ctx.r2),
                     lambda: fk.mont_mul_plain(ctx, table, ctx.r2)),
        "fold": (lambda: fk.fold(ctx, table, r), lambda: fk.fold_plain(ctx, table, r)),
        "halves_sums": (lambda: fk.halves_sums(ctx, table),
                        lambda: fk.halves_sums_plain(ctx, table)),
        "fold_and_halves": (lambda: fk.fold_and_halves(ctx, table, r),
                            lambda: fk.fold_and_halves_plain(ctx, table, r)),
        "gkr_round": (lambda: fk.gkr_round(gctx, stack), lambda: fk.gkr_round_plain(gctx, stack)),
    }
    out = {}
    for name, (kernel, plain) in cases.items():
        cold = time_events(kernel, TIMED_RUNS, flush)
        warm = time_events(kernel, TIMED_RUNS)
        plain_ms = time_events(plain, 3 if size > (1 << 20) else 5, flush)
        nbytes, mads = roofline.FIELD_KERNEL_COSTS[name](size, ctx.num_words)
        b = roofline.bound(nbytes, mads)
        rec = {
            "ms": cold, "warm_ms": warm, "plain_ms": plain_ms, "bytes": nbytes,
            "gb_per_s": nbytes / (cold * 1e-3) / 1e9, "bound_ms": b.ms, "bound_by": b.by,
        }
        out[name] = rec
        if name == "halves_sums":
            # a library reduction over the same bytes: signed columns, not the
            # kernel's function, so not its library_ms; a yardstick of the rate
            half = size // 2
            rec["yardstick_ms"] = time_events(
                lambda: torch.sum(table.view(2, half, ctx.num_words), dim=1, dtype=torch.int64),
                TIMED_RUNS, flush)
            say(f"  torch.sum(table.view(2, half, W), dim=1, dtype=torch.int64) "
                f"2^{size.bit_length() - 1}: {rec['yardstick_ms']:.4f} ms cold L2 "
                f"({nbytes / (rec['yardstick_ms'] * 1e-3) / 1e9:.0f} GB/s)")
        before = KERNEL_MS_BEFORE.get((name, size))
        say(f"  {name} 2^{size.bit_length() - 1}: {cold:.4f} ms cold L2 "
            + (f"(before the redesign: {before:.4f}) " if before else "")
            + f"({rec['gb_per_s']:.0f} GB/s of {nbytes} bytes), {warm:.4f} ms warm, "
            f"plain {plain_ms:.2f} ms, bound {rec['bound_ms']:.4f} ms by {rec['bound_by']} "
            f"(bytes {b.bytes_ms:.4f} ms, operations {b.ops_ms:.4f} ms; {rec['bound_ms'] / cold:.1%} "
            f"of it)")
    return out


def phase_kernel_times(ctx) -> dict[int, dict[str, dict]]:
    """Each kernel alone at every size of TIME_SIZES: size -> name -> record."""
    rng = np.random.default_rng(2)
    flush = torch.empty(256 << 20, dtype=torch.int8, device=ctx.device)
    r = random_table(ctx, rng)
    out = {}
    for size in TIME_SIZES:
        out[size] = time_kernels_at(ctx, rng, flush, r, size)
        torch.cuda.empty_cache()
    return out


def phase_path_times(ctx, poly) -> None:
    """Warm prove and verify at 2^NUM_VARS, and where the prover's time goes."""
    proves, verifies = [], []
    for _ in range(3):
        t0 = time.time()
        proof = fused.prove(poly)
        torch.cuda.synchronize()
        proves.append(time.time() - t0)
        t0 = time.time()
        check(protocol.verify(poly, proof), "warm verify failed")
        torch.cuda.synchronize()
        verifies.append(time.time() - t0)
    t_prove, t_verify = statistics.median(proves), statistics.median(verifies)
    say(f"  warm 2^{NUM_VARS}: prove {t_prove:.4f}s  verify {t_verify:.4f}s  "
        f"prove+verify {t_prove + t_verify:.4f}s (median of 3, host clock, synchronised)")

    def host_ms(fn, n=20):
        fn()
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.time() - t0) / n * 1e3

    # a round's transcript step: one round_step launch, and its plain version
    # (the eager chain of canonical form, absorb and challenge that it replaced)
    state = torch.arange(25, dtype=torch.int64, device=ctx.device)
    rows = torch.ones((2, ctx.num_words + fk.EXTRA_WORDS), dtype=torch.int32, device=ctx.device)
    ms_step = host_ms(lambda: tk.round_step(ctx, rows, state))
    ms_plain = host_ms(lambda: tk.round_step_plain(ctx, rows, state), 5)
    say(f"  a round's transcript step, per call (host clock, synchronised): round_step "
        f"{ms_step:.4f} ms, its plain version {ms_plain:.3f} ms; {NUM_VARS} a prove: "
        f"{NUM_VARS * ms_step:.2f} ms of the warm prove's {t_prove * 1e3:.2f} ms")


def count_syncs(fn):
    """Run ``fn`` and count the synchronising calls PyTorch made (blocking
    copies either way, ``item``), as its sync debug mode reports them."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchronizing CUDA operation" in str(w.message) for w in caught)


def count_device_kernels(fn) -> int:
    """Device kernels launched by ``fn``, from a torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.device_time_total > 0)


def phase_gkr_times(ctx, circuit, inputs, proved) -> None:
    """Warm prove_layers and verify_layers at 2^GKR_NUM_VARS inputs, the
    synchronising calls of a proof, and the eager glue of a round."""
    n = GKR_NUM_VARS
    proves, verifies = [], []
    for _ in range(3):
        t0 = time.time()
        again = gkr.prove_layers(circuit, inputs)
        torch.cuda.synchronize()
        proves.append(time.time() - t0)
        t0 = time.time()
        check(gkr.verify_layers(again.proof, circuit, again.input_evals).verified, "warm verify failed")
        torch.cuda.synchronize()
        verifies.append(time.time() - t0)
    check(same_layers_proof(again, proved), "a warm proof differs from the first")
    t_prove, t_verify = statistics.median(proves), statistics.median(verifies)
    say(f"  warm GKR 2^{n} inputs: prove_layers {t_prove:.4f}s  verify_layers {t_verify:.4f}s  "
        f"together {t_prove + t_verify:.4f}s (median of 3, host clock, synchronised; "
        f"runs {' '.join(f'{t:.3f}' for t in proves)} / {' '.join(f'{t:.3f}' for t in verifies)})")

    _, syncs_prove = count_syncs(lambda: gkr.prove_layers(circuit, inputs))
    _, syncs_verify = count_syncs(
        lambda: gkr.verify_layers(proved.proof, circuit, proved.input_evals))
    say(f"  synchronising calls: prove_layers {syncs_prove} ({syncs_prove / n:.1f} a layer), "
        f"verify_layers {syncs_verify} ({syncs_verify / n:.1f} a layer)")

    def host_ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.time() - t0) / reps * 1e3

    state = torch.arange(25, dtype=torch.int64, device=ctx.device)
    rows = torch.ones((3, ctx.num_words + fk.EXTRA_WORDS), dtype=torch.int32, device=ctx.device)
    consts = fused_lazy._PhaseConsts(ctx, np.zeros(25, np.int64), np.zeros(8, np.int64))
    ms_step = host_ms(lambda: tk.round_step(ctx, rows, state))
    ms_first = host_ms(lambda: tk.round_step(ctx, rows, consts.state, consts.tail))
    ms_plain = host_ms(lambda: tk.round_step_plain(ctx, rows, state), 5)
    rounds = n * (n + 1)
    say(f"  a fused round's transcript step, per call (host clock, synchronised): round_step "
        f"{ms_step:.4f} ms (a phase's first, two blocks: {ms_first:.4f} ms), its plain version "
        f"{ms_plain:.3f} ms; {rounds} a proof: {rounds * ms_step / 1e3:.3f} s of the warm "
        f"prove_layers' {t_prove:.3f} s")


#: device kernels of one fused 2^20 sumcheck prove and of one fused GKR round
#: before the transcript kernels (PERF.md section 5: their eager chain)
DEVICE_KERNELS_BEFORE = {"sumcheck prove": 13860, "GKR round": 1334}


def phase_device_kernels(ctx, gctx) -> None:
    """The device kernels of phase 4's warm 2^20 sumcheck prove and of one of
    phase 7's fused GKR rounds, by the profiler: at most 3 a round + 10 for the
    prove, at most 5 a round for the GKR phase (gkr_round, finish_rows,
    round_step, fold), then one whole fused layer with its table building. Runs
    last: once the profiler has been on, every later launch in the process
    costs the host more."""
    n = GKR_NUM_VARS
    poly = MultilinearPoly.from_ints(ctx, benchmark_values(NUM_VARS))
    fused.prove(poly)
    before = tk.launches["round_step"]
    kernels = count_device_kernels(lambda: fused.prove(poly))
    check(tk.launches["round_step"] - before == NUM_VARS, "a prove is not a round_step a round")
    say(f"  one fused 2^{NUM_VARS} sumcheck prove (phase 4's): {kernels} device kernels "
        f"(before the transcript kernels: {DEVICE_KERNELS_BEFORE['sumcheck prove']})")
    check(kernels <= 3 * NUM_VARS + 10, f"{kernels} device kernels in a prove")
    del poly

    rng = np.random.default_rng(3)
    log_size = 10
    tables = random_table(gctx, rng, 2, 2, 1 << log_size)
    transcript = Transcript(gctx.spec)
    transcript.append_field_elements([1, 2])
    pairs, tail = transcript.sponge().state_lanes()
    consts = fused_lazy._PhaseConsts(gctx, kd.pairs_to_lanes(pairs), kd.bytes_to_lanes(tail))
    fused_lazy._device_phase(gctx, tables, consts)
    kernels = count_device_kernels(lambda: fused_lazy._device_phase(gctx, tables, consts))
    say(f"  one fused GKR phase of {log_size} rounds (phase 7's rounds): {kernels} device "
        f"kernels, {kernels / log_size:g} a round (before the transcript kernels: "
        f"{DEVICE_KERNELS_BEFORE['GKR round']} a round)")
    check(kernels <= 5 * log_size, f"{kernels / log_size:g} device kernels a GKR round")

    w_vars = 6
    layer_inputs = [int(v) for v in rng.integers(0, 1 << 61, size=1 << w_vars)]
    w_poly = MultilinearPoly.from_ints(gctx, layer_inputs)
    fbc = gkr_lazy.LazyFbc(
        gctx, gkr_lazy._encode(gctx, list(range(1, 1 + (1 << (w_vars - 1))))),
        gkr_lazy._encode(gctx, list(range(7, 7 + (1 << (w_vars - 1))))), w_poly)
    kernels = count_device_kernels(
        lambda: fused_lazy.gkr_prove_lazy_fused(0, fbc, copy.deepcopy(transcript)))
    rounds = 2 * w_vars
    say(f"  one fused layer of {rounds} rounds ({1 << w_vars} inputs, its tables built): "
        f"{kernels} device kernels, {kernels / rounds:.0f} a round; at that rate the "
        f"{n * (n + 1)} rounds of a 2^{n} proof launch about {kernels / rounds * n * (n + 1):.0f}")


# ----------------------------------------------------------------------
# the G1 point kernels: inputs, comparison, times
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


def phase_point_kernel_times() -> dict[int, dict[str, dict]]:
    fq = fb.get_ctx(BLS12_381_FQ)
    rng = np.random.default_rng(6)
    flush = torch.empty(256 << 20, dtype=torch.int8, device=fq.device)
    out = {}
    for n in POINT_TIME_WIDTHS:
        p1, p2 = random_points(rng, n, fq.device), random_points(rng, n, fq.device)
        cases = {
            "point_add": (lambda: pk.point_add(fq, p1, p2), lambda: pk.point_add_plain(fq, p1, p2)),
            "point_double": (lambda: pk.point_double(fq, p1),
                             lambda: pk.point_double_plain(fq, p1)),
        }
        out[n] = {}
        for name, (kernel, plain) in cases.items():
            cold = time_events(kernel, TIMED_RUNS, flush)
            warm = time_events(kernel, TIMED_RUNS)
            plain_ms = time_events(plain, 3, flush)
            b = roofline.bound(*roofline.POINT_KERNEL_COSTS[name](n))
            rec = {"ms": cold, "warm_ms": warm, "plain_ms": plain_ms,
                   "bound_ms": b.ms, "bound_by": b.by}
            out[n][name] = rec
            say(f"  {name} 2^{n.bit_length() - 1} lanes: {cold:.4f} ms cold L2 (before the redesign: "
                f"{POINT_MS_BEFORE[name, n]:.4f}), {warm:.4f} ms warm, plain {plain_ms:.2f} ms, "
                f"bound {rec['bound_ms']:.4f} ms by {rec['bound_by']} (bytes {b.bytes_ms:.4f} ms, "
                f"operations {b.ops_ms:.4f} ms; {rec['bound_ms'] / cold:.1%} of it)")
    # the Horner chain's shapes: one thread's latency and a launch
    for n in HORNER_WIDTHS:
        p1, p2 = random_points(rng, n, fq.device), random_points(rng, n, fq.device)
        add_ms = time_events(lambda: pk.point_add(fq, p1, p2), TIMED_RUNS)
        dbl_ms = [time_events(lambda: pk.point_double(fq, p1, times), TIMED_RUNS)
                  for times in HORNER_TIMES]
        say(f"  width {n}: point_add {add_ms:.4f} ms; point_double times "
            + ", ".join(f"{t}: {ms:.4f} ms" for t, ms in zip(HORNER_TIMES, dbl_ms))
            + " (CUDA events, L2 warm)")
    # the compaction's shape at 2^20: the first 3/4 of the lanes (digit-0
    # windows, sorted first) infinite on both sides
    n = POINT_TIME_WIDTHS[-1]
    p1, p2 = random_points(rng, n, fq.device), random_points(rng, n, fq.device)
    for pt in (p1, p2):
        pt[2][: 3 * n // 4] = 0
    cold = time_events(lambda: pk.point_add(fq, p1, p2), TIMED_RUNS, flush)
    # products only on the finite quarter
    b = roofline.bound(roofline.point_add_cost(n)[0], roofline.point_add_cost(n // 4)[1])
    say(f"  point_add 2^20 lanes, 75 % infinite in one run: {cold:.4f} ms cold L2; bound "
        f"{b.ms:.4f} ms (bytes of every lane {b.bytes_ms:.4f} ms, operations of the finite "
        f"quarter {b.ops_ms:.4f} ms)")
    # mont_mul at W = 12, the word count of this path's field
    for n in POINT_TIME_WIDTHS:
        table = random_table(fq, rng, n)
        cold = time_events(lambda: fk.mont_mul(fq, table, fq.r2), TIMED_RUNS, flush)
        plain_ms = time_events(lambda: fk.mont_mul_plain(fq, table, fq.r2), 3, flush)
        b = roofline.bound(*roofline.mont_mul_cost(n, 12))
        say(f"  mont_mul W=12 2^{n.bit_length() - 1}: {cold:.4f} ms cold L2, plain {plain_ms:.2f} ms, "
            f"bound {b.ms:.4f} ms (bytes {b.bytes_ms:.4f} ms, operations {b.ops_ms:.4f} ms)")
    return out


# ----------------------------------------------------------------------
# phases 8 to 10: the whole GKR proof with its KZG input proof
# ----------------------------------------------------------------------

def reset_all_launches() -> None:
    fk.reset_launches()
    pk.reset_launches()
    nk.reset_launches()
    tk.reset_launches()
    mk.reset_launches()


def all_launches() -> dict[str, int]:
    return {**fk.launches, **pk.launches, **nk.launches, **tk.launches, **mk.launches}


def kzg_expected_msm_launches(n: int) -> dict[str, int]:
    """The point kernels' and horner's launches of ``prove`` at 2^n inputs.
    Its Pippenger calls: the commitment, one call over 2^n points, then step k
    of the two openings, one batched call of two segments over 2^(n-1-k), each
    at its window c. point_add: the comb's COMB_W - 1 additions, the basis
    chain's n folds, and in each call the bucket reduction's Kogge-Stone and
    pair steps over 2^(c-1) buckets, c - 1 of each (the compaction and
    densifying rounds are compact_add's, the Horner chain horner's). horner:
    one a call. point_double: none (the comb's table is built before the path
    is driven)."""
    windows = [pp.pick_window_bits(1 << n)] + [pp.pick_window_bits_multi(2, 1 << (n - 1 - k))
                                               for k in range(n)]
    return {"point_add": fixed_base.COMB_W - 1 + n + sum(2 * (c - 1) for c in windows),
            "point_double": 0, "horner": len(windows)}


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
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    t0 = time.time()
    proof = gkr.prove(circuit, inputs, taus=taus)
    torch.cuda.synchronize()
    t_prove = time.time() - t0
    prove_launches = all_launches()
    peak = torch.cuda.max_memory_allocated()
    t0 = time.time()
    ok = gkr.verify(proof, circuit)
    torch.cuda.synchronize()
    t_verify = time.time() - t0
    launches = all_launches()
    say(f"  first run: prove {t_prove:.3f}s  verify {t_verify:.3f}s (the host's pairings included)")
    say(f"  launches on the KZG path: {launches}")
    say(f"  peak device memory of prove: {peak / 1e9:.3f} GB (torch.cuda.max_memory_allocated)")
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
    for name in ("gkr_round", "round_step"):
        check(launches[name] == walk[name] == layers_launches[name],
              f"{name} launches differ from the layer walk's")

    p = ctx.spec.modulus
    bad_point = hc.add(kzg.proof[0][n // 2], hc.G1_GEN)
    quotients = list(kzg.proof[0])
    quotients[n // 2] = bad_point
    t0 = time.time()
    check(not gkr.verify(tampered(proof, proof=[quotients, kzg.proof[1]]), circuit),
          "a tampered quotient point was accepted")
    check(not gkr.verify(tampered(proof, commitment=hc.add(kzg.commitment, hc.G1_GEN)), circuit),
          "a tampered commitment was accepted")
    check(not gkr.verify(
        tampered(proof, opened_evals=[(kzg.opened_evals[0] + 1) % p, kzg.opened_evals[1]]), circuit),
        "a tampered opened evaluation was accepted")
    say(f"  tampered quotient point, commitment and opened evaluation refused "
        f"({time.time() - t0:.1f}s, the first two by the host's pairings)")
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
    t0 = time.time()
    check(kzg.commitment == hc.multiply(hc.G1_GEN, input_poly.evaluate_int(taus)),
          "the commitment is not input_poly(taus) * G1")
    for side, point in ((0, layers_proved.r_b), (1, layers_proved.r_c)):
        quotients = kzg.kzg_setup._quotients(kzg.opened_evals[side], point, input_poly)
        for k, q in enumerate(quotients):
            q_at_tau = MultilinearPoly(ctx, fk.to_mont(ctx, q)).evaluate_int(taus[k + 1:])
            want = hc.multiply(hc.G1_GEN, q_at_tau) if q_at_tau else None
            check(kzg.proof[side][k] == want, f"quotient {k} of opening {side} is not q_k(taus) * G1")
    say(f"  commitment == input_poly(taus) * G1; all {2 * n} quotient commitments == "
        f"q_k(tau_k+1..) * G1 by the host's scalar multiplication ({time.time() - t0:.1f}s)")

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
    t0 = time.time()
    on_cpu = gkr.prove(Circuit(cpu_ctx, structure), tie_inputs, taus=tie_taus)
    check(same_input_proof(on_card.input_proof, on_cpu.input_proof),
          f"2^{KZG_CPU_TIE_INPUTS} input proof on the card differs from the CPU's")
    say(f"  2^{KZG_CPU_TIE_INPUTS} input proof on the card == on the CPU "
        f"(the CPU's plain path took {time.time() - t0:.1f}s)")


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0


def phase_kzg_times(ctx, circuit, inputs, proof, taus) -> float:
    n = GKR_NUM_VARS
    proves = []
    for _ in range(3):
        again, t = timed(lambda: gkr.prove(circuit, inputs, taus=taus))
        proves.append(t)
    check(same_input_proof(again.input_proof, proof.input_proof), "a warm proof differs from the first")
    t_prove = statistics.median(proves)
    say(f"  warm GKR 2^{n} inputs: prove {t_prove:.4f}s (median of 3, host clock, "
        f"synchronised; runs {' '.join(f'{t:.3f}' for t in proves)})")

    # the stages, each alone and synchronised
    (layers, input_poly), t_walk = timed(
        lambda: gkr._walk_layers(circuit, inputs, None, None, lambda label: None))
    kzg, t_setup = timed(lambda: KZG.for_poly(input_poly, taus))
    (o_b, o_c), t_open = timed(
        lambda: (kzg.open(layers.r_b, input_poly), kzg.open(layers.r_c, input_poly)))
    _, t_commit = timed(lambda: kzg.commit(input_poly))
    _, t_chain = timed(kzg.collapsed_bases)
    quotients, t_quot = timed(lambda: (kzg._quotients(o_b, layers.r_b, input_poly),
                                       kzg._quotients(o_c, layers.r_c, input_poly)))
    _, t_msms = timed(lambda: kzg._commit_quotients(*quotients))
    bases = kzg.collapsed_bases()
    t_steps = [timed(lambda: pp.msm_pippenger_multi(bases[k], torch.stack([q[k] for q in quotients])))[1]
               for k in range(n)]
    total = t_walk + t_setup + t_open + t_commit + t_chain + t_quot + t_msms
    say(f"  stages of prove, each alone: layer walk {t_walk:.3f}s, KZG set-up (eq table, comb, "
        f"g2 taus on the host) {t_setup:.3f}s, opens {t_open:.3f}s, commit MSM {t_commit:.3f}s, "
        f"basis chain {t_chain:.3f}s, quotient tables {t_quot:.3f}s, quotient MSMs {t_msms:.3f}s; "
        f"sum {total:.3f}s")
    say(f"  each quotient step's batched MSM alone (2 x 2^({n - 1}-k) points, c): " + ", ".join(
        f"{k}: {t * 1e3:.1f} ms (c={pp.pick_window_bits_multi(2, 1 << (n - 1 - k))})"
        for k, t in enumerate(t_steps)))

    t0 = time.time()
    walked = gkr.verify_layers(proof, circuit, tuple(proof.input_proof.opened_evals))
    torch.cuda.synchronize()
    t_layers = time.time() - t0
    t0 = time.time()
    kp = proof.input_proof
    check(KZG.verify(kp.commitment, kp.opened_evals[0], kp.proof[0], walked.r_b,
                     kp.kzg_setup.g2_taus), "KZG.verify refused the opening at r_b")
    t_pair = 2 * (time.time() - t0)
    say(f"  verify: layer walk {t_layers:.3f}s on the card, pairings {t_pair:.3f}s on the host "
        f"(two openings of {n} + 1 Miller loops and one final exponentiation each; one timed, doubled)")

    _, syncs = count_syncs(lambda: gkr.prove(circuit, inputs, taus=taus))
    _, syncs_kzg = count_syncs(lambda: kzg.commit_with_proof_pair(
        (o_b, layers.r_b), (o_c, layers.r_c), input_poly))
    say(f"  synchronising calls: prove {syncs}, of which commit + both proofs {syncs_kzg}")
    return t_prove


# ----------------------------------------------------------------------
# phases 11 to 13: the NTT
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
    set_up = {}
    for log_n in NTT_LOG_SIZES:
        set_up[log_n] = timed(lambda: ntt_benchmark(ctx, log_n))
    say("  set-up (draw, host ints, upload, to_mont): "
        + ", ".join(f"2^{k} {t:.3f}s" for k, (_, t) in set_up.items()))

    reset_all_launches()
    results = {}
    for log_n in NTT_LOG_SIZES:
        x = set_up[log_n][0][0]
        for first in (True, False):
            (fwd, got_f), t_f = timed(lambda: launched(lambda: tn.ntt(ctx, x)))
            (back, got_b), t_b = timed(lambda: launched(lambda: tn.ntt(ctx, fwd, inverse=True)))
            for got, inverse in ((got_f, False), (got_b, True)):
                want = ntt_expected(log_n, inverse, first)
                check(got == want, f"launches of {'first' if first else 'warm'} ntt 2^{log_n} "
                      f"inverse={inverse}: {got} != {want}")
            say(f"  2^{log_n} {'first' if first else 'warm '}: ntt {t_f:.4f}s, inverse {t_b:.4f}s "
                f"(host clock, synchronised); launches {got_f} / {got_b}")
        results[log_n] = (x, set_up[log_n][0][1], fwd, back)

    log_n = NTT_LOG_SIZES[0]
    poly = UnivariatePoly(spec, results[log_n][1])
    (evals, got_e), t_e = timed(lambda: launched(lambda: tn.fft_evaluate(poly)))
    (interp, got_i), t_i = timed(lambda: launched(lambda: tn.fft_interpolate(spec, evals)))
    stages = log_n - nk.LOG_TILE
    check(got_e == {"ntt_phase1": 1, "ntt_stage": stages, "mont_mul": 2},
          f"launches of fft_evaluate: {got_e}")
    check(got_i == {"ntt_phase1": 1, "ntt_stage": stages, "mont_mul": 3},
          f"launches of fft_interpolate: {got_i}")
    launches = all_launches()
    say(f"  2^{log_n} fft_evaluate {t_e:.3f}s, fft_interpolate {t_i:.3f}s (host ints in and out)")
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
        t0 = time.time()
        host = UnivariatePoly(spec, coeffs)
        want = [host.evaluate(pow(omega, i, p)) for i in rows]
        check(got == want, f"ntt outputs {rows} at 2^{log_n} are not the host's Horner evaluations")
        if log_n == NTT_LOG_SIZES[0]:
            check([evals[i] for i in rows] == want, "fft_evaluate differs from ntt")
        say(f"  2^{log_n}: inverse(ntt(x)) == x; outputs {rows} == Horner at w^i "
            f"({time.time() - t0:.1f}s on the host)")
    check(interp.coefficients == poly.coefficients,
          "fft_interpolate(fft_evaluate(poly)) is not poly")
    say(f"  fft_interpolate(fft_evaluate(poly)) == poly at 2^{NTT_LOG_SIZES[0]}")

    cpu = fb.get_ctx(spec, device="cpu")
    x = random_table(ctx, np.random.default_rng(10), 1 << NTT_CPU_TIE_LOG)
    for inverse in (False, True):
        check(torch.equal(tn.ntt(ctx, x, inverse).cpu(), tn.ntt(cpu, x.cpu(), inverse)),
              f"2^{NTT_CPU_TIE_LOG} ntt on the card differs from the CPU's (inverse={inverse})")
    say(f"  2^{NTT_CPU_TIE_LOG} ntt and inverse on the card == on the CPU")


def ntt_record(cold, warm, plain_ms, nbytes, mads) -> dict:
    b = roofline.bound(nbytes, mads)
    return {"ms": cold, "warm_ms": warm, "plain_ms": plain_ms, "bound_ms": b.ms,
            "bound_by": b.by, "bytes_ms": b.bytes_ms, "ops_ms": b.ops_ms}


def phase_ntt_times(ctx, results) -> dict[int, dict[str, dict]]:
    """Each kernel alone at both sizes (ntt_stage: every stage of a transform,
    and their mean as the kernel's record), the twiddle build, warm transforms,
    fft_evaluate / fft_interpolate with the host packing apart."""
    flush = torch.empty(256 << 20, dtype=torch.int8, device=ctx.device)
    out = {}
    for log_n in NTT_LOG_SIZES:
        x = results[log_n][0]
        tw = nk.stage_twiddles(ctx, log_n, False)
        log_tile = min(nk.LOG_TILE, log_n)
        recs = {}
        rec = ntt_record(
            time_events(lambda: nk.ntt_phase1(ctx, x, tw, log_tile), TIMED_RUNS, flush),
            time_events(lambda: nk.ntt_phase1(ctx, x, tw, log_tile), TIMED_RUNS),
            time_events(lambda: nk.ntt_phase1_plain(ctx, x, tw, log_tile), 3, flush),
            *roofline.ntt_phase1_cost(log_n))
        recs["ntt_phase1"] = rec
        say(f"  ntt_phase1 2^{log_n}: {rec['ms']:.4f} ms cold L2 (before the redesign: "
            f"{KERNEL_MS_BEFORE['ntt_phase1', 1 << log_n]:.4f}), {rec['warm_ms']:.4f} ms warm, "
            f"plain {rec['plain_ms']:.2f} ms, bound {rec['bound_ms']:.4f} ms by {rec['bound_by']} "
            f"(bytes {rec['bytes_ms']:.4f} ms, operations {rec['ops_ms']:.4f} ms; "
            f"{rec['bound_ms'] / rec['ms']:.1%} of it)")
        stage_recs = []
        for stage in range(log_tile + 1, log_n + 1):
            rec = ntt_record(
                time_events(lambda: nk.ntt_stage(ctx, x, tw, stage), TIMED_RUNS, flush),
                time_events(lambda: nk.ntt_stage(ctx, x, tw, stage), TIMED_RUNS),
                time_events(lambda: nk.ntt_stage_plain(ctx, x, tw, stage), 3, flush),
                *roofline.ntt_stage_cost(log_n, stage))
            stage_recs.append(rec)
            say(f"  ntt_stage 2^{log_n} stage {stage}: {rec['ms']:.4f} ms cold L2, "
                f"{rec['warm_ms']:.4f} ms warm, plain {rec['plain_ms']:.2f} ms, "
                f"bound {rec['bound_ms']:.4f} ms by {rec['bound_by']}")
        mean = {k: statistics.fmean(r[k] for r in stage_recs)
                for k in ("ms", "warm_ms", "plain_ms", "bound_ms", "bytes_ms", "ops_ms")}
        mean["bound_by"] = "bytes" if mean["bytes_ms"] >= mean["ops_ms"] else "operations"
        recs["ntt_stage"] = mean
        say(f"  ntt_stage 2^{log_n}, mean of {len(stage_recs)} stages: {mean['ms']:.4f} ms cold, "
            f"bound {mean['bound_ms']:.4f} ms, plain {mean['plain_ms']:.2f} ms; all "
            f"{len(stage_recs)} together {sum(r['ms'] for r in stage_recs):.4f} ms")

        builds = {inverse: time_events(lambda: nk.build_twiddles(ctx, log_n, inverse), TIMED_RUNS)
                  for inverse in (False, True)}
        t_fwd = time_events(lambda: tn.ntt(ctx, x), TIMED_RUNS, flush)
        t_inv = time_events(lambda: tn.ntt(ctx, x, inverse=True), TIMED_RUNS, flush)
        bound = sum(roofline.bound(*cost).ms for cost in roofline.ntt_cost(log_n))
        say(f"  ntt 2^{log_n} warm: forward {t_fwd:.4f} ms, inverse {t_inv:.4f} ms (cold L2; "
            f"bound of the kernels {bound:.4f} ms); twiddle build alone (log_n - 1 = "
            f"{log_n - 1} mont_mul launches and their uploads) {builds[False]:.4f} ms forward, "
            f"{builds[True]:.4f} ms inverse")
        out[log_n] = recs
        torch.cuda.empty_cache()

    log_n = NTT_LOG_SIZES[0]
    poly = UnivariatePoly(ctx.spec, results[log_n][1])
    evals, t_e = timed(lambda: tn.fft_evaluate(poly))
    _, t_i = timed(lambda: tn.fft_interpolate(ctx.spec, evals))
    words, t_pack = timed(lambda: ctx.pack(poly.coefficients))
    table, t_up = timed(lambda: ctx.to_device(words))
    _, t_down = timed(lambda: [int(v) for v in ctx.unpack(table)])
    say(f"  2^{log_n} fft_evaluate {t_e:.3f}s, fft_interpolate {t_i:.3f}s (host clock); of each, "
        f"host packing of the ints {t_pack:.3f}s, upload {t_up:.4f}s, download and unpacking "
        f"{t_down:.3f}s")
    return out


def all_lanes() -> dict[str, int]:
    return {**fk.lanes, **pk.lanes, **nk.lanes, **tk.lanes, **mk.lanes}


#: run_scan's three device kernels, one of each a launch
SCAN_PASSES = ("run_scan_reduce", "run_scan_blocks", "run_scan_apply")
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


def profile_path(fn) -> dict:
    """Run ``fn`` once under torch.profiler (device activity only): its
    launches, lanes and point doublings by kernel, and the device milliseconds
    of each kernel, summed by the device function's name (``finish_rows``, the
    second pass of the three summing kernels, and run_scan's three passes
    apart; run_scan's time is its passes' sum), and the device kernels of
    torch.cummax and torch.searchsorted that ran."""
    from torch.profiler import ProfilerActivity, profile

    reset_all_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    t_run = time.time() - t0
    names = (fk.KERNEL_NAMES + pk.KERNEL_NAMES + nk.KERNEL_NAMES + tk.KERNEL_NAMES
             + mk.KERNEL_NAMES + ("finish_rows",) + SCAN_PASSES)
    device_ms = {name: 0.0 for name in names}
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
                device_ms[found.group(1)] += e.duration_ns() / 1e6
                device_n[found.group(1)] += 1
    device_ms["run_scan"] = sum(device_ms[name] for name in SCAN_PASSES)
    return {"launches": all_launches(), "lanes": all_lanes(), "doublings": pk.doublings,
            "rounds": dict(tk.rounds), "scan_slots": mk.scan_slots, "chains": dict(mk.chains),
            "device_ms": device_ms, "device_n": device_n, "scan_ops": scan_op_runs(kernel_names),
            "seconds": t_run, "total_s": time.time() - t0}


def check_msm_launches(path: str, p: dict) -> None:
    """compact_add and horner are one device kernel a wrapper launch, run_scan
    one of each of its three passes; no cummax or searchsorted kernel runs."""
    ran, launched = p["device_n"], p["launches"]
    for name in ("compact_add", "horner") + SCAN_PASSES:
        want = launched["run_scan" if name in SCAN_PASSES else name]
        check(ran[name] == want, f"{path}: {ran[name]} {name} kernels ran for {want} launches")
    check(not any(p["scan_ops"].values()),
          f"{path} ran torch.cummax or torch.searchsorted kernels: {p['scan_ops']}")


def check_one_launch(profiles: dict[str, dict]) -> None:
    """halves_sums, fold_and_halves and the two transcript kernels are one
    device kernel a wrapper launch, and finish_rows runs after gkr_round alone:
    on every profiled path the device's count of each kernel equals its
    wrapper's launches, so the sumcheck path (1 + 19 launches, no gkr_round)
    runs no finish_rows; each path's transcript is a round_step a round (a
    gkr_round a round on the GKR paths), and no path launches keccak_f (its
    permutations run inside round_step). The MSM kernels as
    ``check_msm_launches`` says, and the KZG path's window combines are one
    horner launch each, with no point_double."""
    one_launch = fk._ONE_LAUNCH + tk.KERNEL_NAMES
    for path, p in profiles.items():
        ran, launched = p["device_n"], p["launches"]
        for name in one_launch:
            check(ran[name] == launched[name],
                  f"{path}: {ran[name]} {name} kernels ran for {launched[name]} launches")
        check(ran["finish_rows"] == launched["gkr_round"],
              f"{path}: {ran['finish_rows']} finish_rows kernels ran for "
              f"{launched['gkr_round']} gkr_round launches")
        check(launched["keccak_f"] == 0, f"{path} launched keccak_f")
        rounds = NUM_VARS if path == "sumcheck" else launched["gkr_round"]
        check(launched["round_step"] == rounds,
              f"{path}: {launched['round_step']} round_step launches for {rounds} rounds")
        check_msm_launches(path, p)
    kzg = profiles["gkr_kzg"]
    check(kzg["launches"]["horner"] == 1 + GKR_NUM_VARS and kzg["launches"]["point_double"] == 0
          and kzg["launches"]["run_scan"] == KZG_COMPACT_ROUNDS_2E20,
          f"profiled gkr.prove: horner, point_double, run_scan launches {kzg['launches']}")
    sumcheck = profiles["sumcheck"]
    for name in fk._ONE_LAUNCH + ("round_step",):
        check(sumcheck["launches"][name] == EXPECTED_LAUNCHES[name],
              f"profiled sumcheck: {sumcheck['launches'][name]} {name} launches")
    check(sumcheck["device_n"]["finish_rows"] == 0, "finish_rows ran on the sumcheck path")
    say("  one device kernel a launch of halves_sums, fold_and_halves, round_step, keccak_f, "
        "compact_add and horner on every path, three of run_scan, finish_rows only after "
        "gkr_round, no cummax or searchsorted kernel: " + ", ".join(
            f"{path} {p['device_n']['halves_sums']} + {p['device_n']['fold_and_halves']}, "
            f"round_step {p['device_n']['round_step']}, finish_rows {p['device_n']['finish_rows']}, "
            f"run_scan passes {[p['device_n'][name] for name in SCAN_PASSES]}, compact_add "
            f"{p['device_n']['compact_add']}, horner {p['device_n']['horner']}, "
            f"scan ops {p['scan_ops']}" for path, p in profiles.items()))


def print_ranking(kernels: list[dict], profiles: dict[str, dict]) -> list[dict]:
    """The fourteen kernels ranked by device ms on the four paths (one profiled run
    of each) less the bound of the lanes they covered there; then, for
    comparison, the earlier ranking (launches x (ms - bound_ms) at each row's
    size), which prices every launch at the row's width."""
    rounds, chains = {}, {}  # round_step's launches and horner's segments by kind
    for p in profiles.values():
        for kind, n in p["rounds"].items():
            rounds[kind] = rounds.get(kind, 0) + n
        for kind, n in p["chains"].items():
            chains[kind] = chains.get(kind, 0) + n
    scan_slots = sum(p["scan_slots"] for p in profiles.values())
    rows = []
    for k in kernels:
        name = k["name"]
        launches = sum(p["launches"][name] for p in profiles.values())
        lanes = sum(p["lanes"][name] for p in profiles.values())
        doublings = sum(p["doublings"] for p in profiles.values()) if name == "point_double" else 0
        device = sum(p["device_ms"][name] for p in profiles.values())
        bound = roofline.lanes_bound_ms(name, lanes, doublings, rounds=rounds,
                                        scan_slots=scan_slots, chains=chains)
        rows.append({"name": name, "launches": launches, "lanes": lanes, "device_ms": device,
                     "bound_ms": bound, "loss_ms": device - bound})
    rows.sort(key=lambda r: -r["loss_ms"])
    say("  kernels at real widths, by device ms on the paths - bound of their lanes "
        "(point_add's bound counts every lane as finite, compact_add's prices no addition):")
    for r in rows:
        say(f"    {r['name']}: {r['launches']} launches, {r['lanes']} lanes, {r['device_ms']:.3f} "
            f"device ms, bound {r['bound_ms']:.3f} ms, loss {r['loss_ms']:.3f} ms")
    finish = sum(p["device_ms"]["finish_rows"] for p in profiles.values())
    say(f"    (finish_rows, gkr_round's second pass: {finish:.3f} device ms; launches by path: "
        + ", ".join(f"{path} {p['device_n']['finish_rows']}" for path, p in profiles.items())
        + ")")
    say("  by path: " + "; ".join(
        f"{path} ({p['seconds']:.1f}s profiled, {p['total_s']:.1f}s with the summary): "
        + ", ".join(f"{n} {v:.2f}" for n, v in p["device_ms"].items() if v)
        for path, p in profiles.items()))
    ranked = sorted(kernels, key=lambda k: -k["launches"] * (k["ms"] - k["bound_ms"]))
    say("  earlier ranking, kernels by launches x (ms - bound_ms) at each row's size: " + "; ".join(
        f"{k['name']} {k['launches']} x ({k['ms']:.4f} - {k['bound_ms']:.4f}) = "
        f"{k['launches'] * (k['ms'] - k['bound_ms']):.1f} ms" for k in ranked))
    return rows


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
        t0 = time.time()
        bad = oracle_mismatches(ctx, rng, ORACLE_LOG_SIZE, every_kernel)
        torch.cuda.synchronize()
        say(f"  {spec.name} (W = {ctx.num_words}), 2^{ORACLE_LOG_SIZE} entries: mismatches "
            + " ".join(f"{k}={v}" for k, v in bad.items()) + f" ({time.time() - t0:.1f}s)")
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


def phase_proof_bytes(sum_proof, gkr_blob: bytes, gkr_encode_s: float, kept, circuit, walk) -> None:
    """The 2^20 sumcheck proof and the whole 2^20-input GKR proof as bytes:
    digest, round trips, the decoded proof against the one in memory (``kept``,
    without its device SRS), verify on the card, three tampered blobs."""
    blob, t_enc = timed(lambda: ser.encode_sumcheck_proof(sum_proof, BN254_FQ))
    back, t_dec = timed(lambda: ser.decode_sumcheck_proof(blob, BN254_FQ))
    digest = hk.keccak256(blob).hex()
    say(f"  2^{NUM_VARS} sumcheck blob: {len(blob)} bytes, encode {t_enc * 1e3:.3f} ms, "
        f"decode {t_dec * 1e3:.3f} ms; digest {digest}")
    check(digest == SUMCHECK_BLOB_DIGEST_2E20,
          f"sumcheck blob digest differs from the stored {SUMCHECK_BLOB_DIGEST_2E20}")
    check(back == sum_proof and ser.encode_sumcheck_proof(back, BN254_FQ) == blob,
          "the sumcheck blob does not round-trip")
    # both blobs hashed on the card as well: keccak256_device, a keccak_f launch a block
    for name, data in (("sumcheck", blob), ("GKR", gkr_blob)):
        before = tk.launches["keccak_f"]
        on_card, t_card = timed(lambda: kd.digest_to_bytes(kd.keccak256_device(data, "cuda")))
        blocks = len(data) // kd.RATE + 1
        check(on_card == hk.keccak256(data), f"the {name} blob's digest on the card differs")
        check(tk.launches["keccak_f"] - before == blocks, f"{name} blob: not a keccak_f a block")
        say(f"  the {name} blob's digest on the card == the host's: {blocks} keccak_f launches, "
            f"{t_card * 1e3:.1f} ms")

    decoded, t_dec = timed(lambda: ser.decode_gkr_proof(gkr_blob))
    say(f"  2^{GKR_NUM_VARS}-input GKR proof blob: {len(gkr_blob)} bytes, encode "
        f"{gkr_encode_s * 1e3:.1f} ms, decode {t_dec * 1e3:.1f} ms (device None: the card)")
    check(decoded.output_poly.table.device == circuit.ctx.device,
          "the decoded output table is not on the card")
    check(ser.encode_gkr_proof(decoded) == gkr_blob, "the GKR blob does not round-trip")
    check(same_layers_proof(walk_of(decoded, walk), walk_of(kept, walk))
          and same_input_proof(decoded.input_proof, kept.input_proof)
          and decoded.input_proof.kzg_setup.g2_taus == kept.input_proof.kzg_setup.g2_taus,
          "the decoded GKR proof differs from the proof in memory")
    ok, t_verify = timed(lambda: gkr.verify(decoded, circuit))
    check(ok, "verify refused the GKR proof decoded from bytes")
    say(f"  decoded GKR proof == the proof in memory; re-encodes to the same bytes; "
        f"gkr.verify accepts it on the card ({t_verify:.1f}s)")
    t0 = time.time()
    verdicts = {name: blob_verdict(bad, circuit) for name, bad in tampered_blobs(gkr_blob, kept).items()}
    say(f"  tampered blobs: {verdicts} ({time.time() - t0:.1f}s)")
    for name, verdict in verdicts.items():
        check(verdict in ("raised", "refused"), f"a blob with a changed {name} was accepted")


# ----------------------------------------------------------------------
# phase 16: the mesh paths
# ----------------------------------------------------------------------

def phase_batched_ntt_kernels_vs_plain() -> dict[str, int]:
    """ntt_phase1 (at the full tile) and every later ntt_stage on batches of
    tables, forward and inverse twiddles, word for word against the plain
    versions; then each kernel's time on the 2^20- and 2^22-entry batches of
    the four-step NTT beside its bound and the unbatched table's time."""
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

    flush = torch.empty(256 << 20, dtype=torch.int8, device=ctx.device)
    for log_n, batch in NTT_BATCH_CHECKS[:2]:
        x = random_table(ctx, rng, batch, 1 << log_n)
        flat = x.reshape(batch << log_n, -1)
        log_flat = flat.shape[0].bit_length() - 1
        tw = nk.stage_twiddles(ctx, log_n, False)
        tw_flat = nk.stage_twiddles(ctx, log_flat, False)
        tile = min(nk.LOG_TILE, log_n)
        ms = time_events(lambda: nk.ntt_phase1(ctx, x, tw, tile), TIMED_RUNS, flush)
        alone = time_events(lambda: nk.ntt_phase1(ctx, flat, tw_flat, tile), TIMED_RUNS, flush)
        b = roofline.bound(*roofline.ntt_phase1_cost(log_n, batch))
        line = (f"  {batch} x 2^{log_n}: ntt_phase1 {ms:.4f} ms (bound {b.ms:.4f} by {b.by}; one "
                f"table of 2^{log_flat}: {alone:.4f} ms)")
        if log_n > nk.LOG_TILE:
            ms = time_events(lambda: nk.ntt_stage(ctx, x, tw, log_n), TIMED_RUNS, flush)
            b = roofline.bound(*roofline.ntt_stage_cost(log_n, log_n, batch))
            line += f", ntt_stage {log_n} {ms:.4f} ms (bound {b.ms:.4f} by {b.by})"
        say(line + " (CUDA events, median, L2 flushed)")
        del x, flat
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
    return poly


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
    ladder, t_ladder = timed(lambda: pm.msm_sharded(mesh, basis, scalars))
    check(dc.unpack_points(tuple(t[None] for t in ladder))[0] == commitment,
          "msm_sharded (the ladder) of the commitment differs from phase 8's")
    say(f"  msm_pippenger_sharded and msm_sharded (the double-and-add ladder, {t_ladder:.3f}s) of "
        f"the 2^{GKR_NUM_VARS}-point commitment == phase 8's commitment (window "
        f"{pp.pick_window_bits((1 << GKR_NUM_VARS) // mesh.size)} a slot)")
    return basis, scalars


def mesh_times(mesh, ctx, rctx, poly, ntt_outputs, basis, scalars) -> None:
    """Each sharded path's warm time beside the single device's (host clock,
    synchronised, median of MESH_TIMED_RUNS; the NTT by CUDA events)."""
    def warm(fn):
        fn()
        runs = [timed(fn)[1] for _ in range(MESH_TIMED_RUNS)]
        return statistics.median(runs)

    t_sharded = warm(lambda: pm.sumcheck_prove_sharded(poly, mesh))
    t_single = warm(lambda: protocol.prove(poly))
    t_fused = warm(lambda: fused.prove(poly))
    say(f"  warm 2^{NUM_VARS} sumcheck: sharded {t_sharded:.4f}s, protocol.prove {t_single:.4f}s, "
        f"fused.prove {t_fused:.4f}s")
    t_sharded = warm(lambda: pm.msm_pippenger_sharded(mesh, basis, scalars))
    t_single = warm(lambda: pp.msm_pippenger(basis, scalars))
    say(f"  warm 2^{GKR_NUM_VARS}-point commitment MSM: sharded {t_sharded:.4f}s, "
        f"msm_pippenger {t_single:.4f}s")
    for log_n, (x, fwd) in ntt_outputs.items():
        parts = []
        for inverse, src in ((False, x), (True, fwd)):
            ms = time_events(lambda: pm.ntt_sharded(rctx, mesh, src, inverse), TIMED_RUNS)
            single = time_events(lambda: tn.ntt(rctx, src, inverse), TIMED_RUNS)
            parts.append(f"{'inverse' if inverse else 'forward'} sharded {ms:.4f} ms, ntt {single:.4f} ms")
        say(f"  warm 2^{log_n} NTT (CUDA events, median of {TIMED_RUNS}): " + "; ".join(parts))


def phase_mesh_paths(ctx, gctx, rctx, sum_proof, circuit, inputs, taus, gkr_blob, commitment,
                     ntt_outputs, t_prove_single):
    """The mesh paths on the one-card mesh of MESH_SLOTS slots and on the mesh of
    every card present. Returns the launches of the paths (the timing reruns
    after them not counted)."""
    meshes = [("4-slot", pm.make_mesh(devices=[torch.device("cuda", 0)] * MESH_SLOTS)),
              ("all-cards", pm.make_mesh())]
    launches = {name: 0 for name in all_launches()}
    for label, mesh in meshes:
        say(f"  -- {label} mesh: {mesh}")
        t0 = time.time()
        reset_all_launches()
        poly = mesh_sumcheck(mesh, ctx, sum_proof)
        mesh_ntt(mesh, rctx, ntt_outputs)
        basis, scalars = mesh_commitment(mesh, gctx, inputs, taus, commitment)
        if label == "4-slot":
            proof, t_mesh = timed(lambda: gkr.prove(circuit, inputs, taus=taus, mesh=mesh))
            blob = ser.encode_gkr_proof(proof)
            check(blob == gkr_blob, "gkr.prove(mesh=...) does not encode to phase 8's bytes")
            say(f"  gkr.prove(mesh=...) of the 2^{GKR_NUM_VARS}-input circuit encodes to phase 8's "
                f"{len(blob)} bytes: {t_mesh:.3f}s (phase 10's warm prove {t_prove_single:.3f}s)")
            del proof
        seconds, t_dry = timed(lambda: dryrun_multichip(mesh))
        say(f"  dryrun_multichip passes ({t_dry:.1f}s): "
            + ", ".join(f"{k} {v:.3f}s" for k, v in seconds.items()))
        got = all_launches()
        say(f"  launches on the {label} mesh's paths: {got}")
        for name, v in got.items():
            launches[name] += v
        if label == "4-slot":
            # its sharded commitment and segment-sharded quotient MSMs once more,
            # under the profiler (not counted above)
            prof = profile_path(lambda: gkr.prove(circuit, inputs, taus=taus, mesh=mesh))
            check_msm_launches("gkr.prove(mesh=...)", prof)
            say(f"  gkr.prove(mesh=...) under the profiler: run_scan {prof['launches']['run_scan']}, "
                f"compact_add {prof['launches']['compact_add']}, horner "
                f"{prof['launches']['horner']} launches, one device kernel each (run_scan three); "
                f"cummax and searchsorted kernels {prof['scan_ops']}")
        mesh_times(mesh, ctx, rctx, poly, ntt_outputs, basis, scalars)
        del poly, basis, scalars
        torch.cuda.empty_cache()
        say(f"  {label} mesh: {time.time() - t0:.1f}s")
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
#: launches a transcript kernel is timed over, by the profiler's device clock
TRANSCRIPT_TIMED_RUNS = 200


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


def device_ms(fn, kernel: str, runs: int = TRANSCRIPT_TIMED_RUNS) -> float:
    """Median device milliseconds of ``kernel``'s launches over ``runs`` calls
    of ``fn``, by the profiler's device clock: a launch of a one-thread kernel
    takes microseconds, and a CUDA event pair around one call would time the
    wrapper's host path instead."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    durations = [e.duration_ns() for e in prof.profiler.kineto_results.events()
                 if e.device_type().name == "CUDA" and f"{kernel}_kernel" in e.name()]
    # late in a long process the tracer may drop a few of a burst's records
    check(runs // 2 <= len(durations) <= runs,
          f"{kernel}: {len(durations)} device kernels traced for {runs} calls")
    return statistics.median(durations) / 1e6


def transcript_record(name: str, ms: float, plain_ms: float, cost, what: str) -> dict:
    b = roofline.bound(*cost)
    chain_ms = roofline.one_thread_ms(cost[1])
    say(f"  {name}, {what}: {ms * 1e3:.3f} us a launch on the device, plain {plain_ms:.3f} ms, "
        f"bound {b.ms * 1e6:.4f} ns by {b.by} (bytes {b.bytes_ms * 1e6:.4f} ns, operations "
        f"{b.ops_ms * 1e6:.4f} ns), one thread's least time {chain_ms * 1e3:.3f} us "
        f"({cost[1]} operations at one a cycle)")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b.ms, "bound_by": b.by,
            "one_thread_ms": chain_ms}


def phase_transcript_kernels() -> tuple[dict[str, int], dict[str, dict]]:
    """keccak_f and round_step against their plain versions, word for word, then
    their times at the paths' shapes."""
    t0 = time.time()
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

    times = {}
    state = random_lanes(rng, 25, device)
    times["keccak_f"] = transcript_record(
        "keccak_f", device_ms(lambda: tk.keccak_f(state), "keccak_f"),
        time_events(lambda: tk.keccak_f_plain(state), 5), roofline.keccak_f_cost(1),
        "one state (a block of keccak256_device)")
    wide = random_lanes(rng, 25 * 4096, device).reshape(4096, 25)
    transcript_record("keccak_f", device_ms(lambda: tk.keccak_f(wide), "keccak_f", 20),
                      time_events(lambda: tk.keccak_f_plain(wide), 3),
                      roofline.keccak_f_cost(4096), "4096 states")
    gctx, sctx = fb.get_ctx(BLS12_381_FR), fb.get_ctx(BN254_FQ)
    for label, ctx, k, tail in (("a steady GKR round", gctx, 3, None),
                                ("a steady sumcheck round", sctx, 2, None),
                                ("a GKR phase's first round, two blocks", gctx, 3, 16)):
        rows, state, tail_lanes = round_check_inputs(ctx, rng, k, tail, 3)
        rec = transcript_record(
            "round_step", device_ms(lambda: tk.round_step(ctx, rows, state, tail_lanes),
                                    "round_step"),
            time_events(lambda: tk.round_step_plain(ctx, rows, state, tail_lanes), 5),
            roofline.round_step_cost(k, 4 if tail is None else tail, 1 if tail is None else 2,
                                     tail is not None), label)
        times.setdefault("round_step", rec)
    torch.cuda.synchronize()
    say(f"  (phase 17 took {time.time() - t0:.1f}s)")
    return errs, times


# ----------------------------------------------------------------------
# phase 18: the MSM kernels
# ----------------------------------------------------------------------

#: run_scan against its plain version at these key counts (compact_add up to
#: 2^20 on random points, and at 2^24 on the commitment's first round)
SCAN_CHECK_WIDTHS = (1, 2, 3, 127, 128, 129, 4095, 4096, 4097, 1 << 16, (1 << 16) + 1, 1 << 20,
                     1 << 24)
COMPACT_CHECK_TOP = 1 << 20
#: run lengths of the key set whose runs cross the scan's tiles (16 keys) and
#: blocks (4096 keys)
CROSSING_RUNS = (1, 2, 3, 15, 16, 17, 31, 33, 4095, 4096, 4097, 8193)
#: horner against its plain version: segments, window widths, points a segment;
#: below c = 16 over the most significant windows only (a plain chain is some
#: 250 doublings of about 0.1 s each on the card, launch-bound; the whole
#: chains at c = 4 and 8 are held against the eager chain in the timings)
HORNER_CHECK_SEGMENTS = (1, 2, 4)
HORNER_CHECK_WINDOWS = (4, 8, 16)
HORNER_CHECK_POINTS = 1 << 10
HORNER_CHECK_TOP_WINDOWS = 8
#: the quotient steps' Horner chains, timed beside the eager chain after the
#: commitment's: (segments, c)
HORNER_TIME_SHAPES = ((2, 16), (2, 8), (2, 4))


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
    and two selects. Timed beside run_scan + compact_add."""
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
    """A copy of ``pt`` whose first survivors that have a partner meet the edge
    cases in turn: equal points (the doubling branch), opposite points, the left
    infinite, the right infinite, both infinite."""
    pt = tuple(t.clone() for t in pt)
    n = key.shape[0]
    lefts = srcpos[: int(count)].cpu().tolist()
    keys = key.cpu()
    pairs = [i for i in lefts if i + 1 < n and int(keys[i + 1]) == int(keys[i])]
    picks = pairs[:10] + pairs[len(pairs) // 2:][:5] + pairs[-5:]
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
    l_next below, at and above the survivor count, and compact_add on random
    points (edge neighbours planted) up to COMPACT_CHECK_TOP, word for word."""
    fq = dc.fq_ctx(pool[0].device)
    errs = {"run_scan": 0, "compact_add": 0}
    cases = rounds = planted = 0
    for n in SCAN_CHECK_WIDTHS:
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
                if n > COMPACT_CHECK_TOP or name != "runs across tiles and blocks":
                    continue
                pt, k = plant_neighbours(fq, key, tuple(v[:n] for v in pool), want[0], want[1])
                planted += k
                err = round_err(mk.compact_add(key, pt, *got[:2]),
                                mk.compact_add_plain(key, pt, *want[:2]))
                check(err == 0, f"compact_add differs from its plain version ({n} keys, "
                      f"l_next {l_next})")
                errs["compact_add"] = max(errs["compact_add"], err)
                rounds += 1
    torch.cuda.synchronize()
    say(f"  run_scan == its plain version in {cases} cases ({len(SCAN_CHECK_WIDTHS)} widths from 1 "
        f"to {max(SCAN_CHECK_WIDTHS)} keys, five key sets, l_next below, at and above the count); "
        f"compact_add in {rounds} rounds up to {COMPACT_CHECK_TOP} keys, {planted} planted "
        f"neighbours (equal, opposite, infinite)")
    return errs


def check_horner(rng, pool) -> tuple[dict[str, int], float]:
    """horner at HORNER_CHECK_SEGMENTS x HORNER_CHECK_WINDOWS on the per-window
    sums of real MSMs, with infinities mixed in, against its plain version
    (computed at the most segments: the lanes are independent). Returns the
    errors and the plain version's ms at c = 16 (a chain of one launch-bound
    eager operation after another: its time hardly depends on the segments)."""
    S = max(HORNER_CHECK_SEGMENTS)
    m = HORNER_CHECK_POINTS
    points = tuple(v[:m].contiguous() for v in pool)
    worst, plain_ms = 0, 0.0
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
        want, t_plain = timed(lambda: mk.horner_plain(per_window, c))
        if c == 16:
            plain_ms = t_plain * 1e3
        for segments in HORNER_CHECK_SEGMENTS:
            got = mk.horner(tuple(v[:segments].contiguous() for v in per_window), c)
            err = triple_err(got, tuple(v[:segments] for v in want))
            check(err == 0, f"horner differs from its plain version ({segments} segments, c={c})")
            worst = max(worst, err)
        check(dc.unpack_points(tuple(v[3:4] for v in want)) == [None], "an all-infinite chain")
    say(f"  horner == its plain version at {HORNER_CHECK_SEGMENTS} segments and c in "
        f"{HORNER_CHECK_WINDOWS} (below 16 the top {HORNER_CHECK_TOP_WINDOWS} windows), on the "
        f"window sums of MSMs of {m} points, infinities mixed in; the plain version at {S} "
        f"segments, c = 16: {plain_ms:.1f} ms")
    return {"horner": worst}, plain_ms


def time_round(flush, skey, pt, l_next: int, what: str):
    """run_scan and compact_add of one real round beside their plain versions,
    their bounds and the eager round they replace, all with equal results:
    (the two kernels' records, the round's output)."""
    scan = mk.run_scan(skey, l_next)
    check(max(max_abs_err(g, w) for g, w in zip(scan, mk.run_scan_plain(skey, l_next))) == 0,
          f"run_scan differs from its plain version on {what}")
    out = mk.compact_add(skey, pt, *scan[:2])
    plain, t_plain = timed(lambda: mk.compact_add_plain(skey, pt, *scan[:2]))
    check(round_err(out, plain) == 0, f"compact_add differs from its plain version on {what}")
    del plain
    check(round_err(out, eager_compact_round(skey, pt, l_next)) == 0,
          f"the eager round differs on {what}")
    n = skey.shape[0]
    survivors = min(int(scan[1]), l_next)
    i = scan[0][:survivors].to(torch.int64)
    j = (i + 1).clamp(max=n - 1)
    adds = int(((i + 1 < n) & (skey[j] == skey[i]) & (pt[2][i] != 0).any(1)
                & (pt[2][j] != 0).any(1)).sum())
    rec = {
        "run_scan": {"ms": time_events(lambda: mk.run_scan(skey, l_next), TIMED_RUNS, flush),
                     "plain_ms": time_events(lambda: mk.run_scan_plain(skey, l_next), 3, flush),
                     "bound": roofline.bound(*roofline.run_scan_cost(n, l_next))},
        "compact_add": {"ms": time_events(lambda: mk.compact_add(skey, pt, *scan[:2]), TIMED_RUNS,
                                          flush),
                        "plain_ms": t_plain * 1e3,
                        "bound": roofline.bound(*roofline.compact_add_cost(l_next, survivors,
                                                                           adds))},
    }
    eager = time_events(lambda: eager_compact_round(skey, pt, l_next), 3, flush)
    say(f"  {what}, {n} keys -> {l_next} slots ({survivors} survivors, {adds} finite additions): "
        f"run_scan + compact_add {rec['run_scan']['ms']:.4f} + {rec['compact_add']['ms']:.4f} ms, "
        f"the eager round {eager:.4f} ms (CUDA events, median, L2 flushed); plain "
        f"{rec['run_scan']['plain_ms']:.2f} + {rec['compact_add']['plain_ms']:.1f} ms; bounds "
        + ", ".join(f"{k} {v['bound'].ms:.4f} ms by {v['bound'].by} ({v['bound'].ms / v['ms']:.1%})"
                    for k, v in rec.items()))
    for v in rec.values():
        b = v.pop("bound")
        v.update(bound_ms=b.ms, bound_by=b.by)
    return rec, out


def time_horner(flush, per_window, c: int) -> dict:
    """horner at one shape beside the eager chain, its bound and one thread's
    least time, with equal results."""
    S, W = per_window[0].shape[:2]
    got = mk.horner(per_window, c)
    check(triple_err(got, eager_horner(per_window, c)) == 0, "the eager chain differs")
    ms = time_events(lambda: mk.horner(per_window, c), TIMED_RUNS, flush)
    eager = time_events(lambda: eager_horner(per_window, c), 3, flush)
    b = roofline.bound(*roofline.horner_cost(S, W, c))
    floor = roofline.one_thread_ms(roofline.horner_chain_ops(W, c))
    say(f"  horner, {S} segment(s), c = {c}: {ms:.4f} ms (CUDA events, median), the eager chain "
        f"{eager:.3f} ms ({2 * (W - 1)} launches); one thread's least time {floor:.4f} ms "
        f"({roofline.horner_chain_ops(W, c)} operations at one a cycle), {floor / ms:.1%} of it; "
        f"bound {b.ms * 1e3:.4f} us by {b.by}")
    return {"ms": ms, "bound_ms": b.ms, "bound_by": b.by, "one_thread_ms": floor, "eager_ms": eager}


def phase_msm_kernels(gctx, inputs, taus) -> tuple[dict[str, int], dict[str, dict]]:
    """run_scan, compact_add and horner against their plain versions, word for
    word, then their times at the KZG path's real widths: the commitment MSM's
    first compaction round (2^24 keys) and a steady one, and the Horner chains
    of the commitment and the quotient steps."""
    t0 = time.time()
    rng = np.random.default_rng(18)
    pool = random_points(rng, COMPACT_CHECK_TOP, gctx.device)
    errs = check_scan_and_round(rng, pool)
    horner_errs, horner_plain_ms = check_horner(rng, pool)
    errs.update(horner_errs)
    del pool
    torch.cuda.empty_cache()

    # the commitment MSM of phase 8: its presorted lanes and first rounds
    flush = torch.empty(256 << 20, dtype=torch.int8, device=gctx.device)
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
    times, (skey, pt) = time_round(flush, skey, pt, sizes[0], "the commitment's first round")
    for l_next in sizes[1:]:
        skey, pt = pp._compact_round(skey, pt, l_next)
    time_round(flush, skey, pt, sizes[-1], "a steady round of the commitment")
    del skey, pt, abs_d, signs
    torch.cuda.empty_cache()

    per_window = pp._window_sums(basis, scalars[None], c)
    times["horner"] = time_horner(flush, tuple(v.contiguous() for v in per_window), c)
    times["horner"]["plain_ms"] = horner_plain_ms
    for segments, cc in HORNER_TIME_SHAPES:
        m = min(1 << 10, n)
        sc = random_scalars(rng, segments * m, basis[0].device).reshape(segments, m, -1)
        pw = pp._window_sums(tuple(v[:m].contiguous() for v in basis), sc, cc)
        time_horner(flush, tuple(v.contiguous() for v in pw), cc)
    say(f"  (phase 18 took {time.time() - t0:.1f}s)")
    return errs, times


# ----------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    t_start = time.time()
    gpu = gpu_line()
    say(f"[1] device: {gpu}")
    say(f"    torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.time()
    _build.build_cuda_libraries(list(CUDA_STEMS))
    fk.library()
    pk.library()
    nk.library()
    tk.library()
    mk.library()
    say(f"    kernels built from {KERNEL_SOURCE} ({_build.build_seconds['sumcheck_kernels']:.1f}s), "
        f"{POINT_KERNEL_SOURCE} ({_build.build_seconds['point_kernels']:.1f}s), "
        f"{NTT_KERNEL_SOURCE} ({_build.build_seconds['ntt_kernels']:.1f}s), "
        f"{TRANSCRIPT_KERNEL_SOURCE} ({_build.build_seconds['transcript_kernels']:.1f}s) and "
        f"{MSM_KERNEL_SOURCE} ({_build.build_seconds['msm_kernels']:.1f}s), side by "
        f"side in {time.time() - t0:.1f}s (0.0 = already built)")
    for stem, needles in (("sumcheck_kernels", ("gkr_round_kernel", "halves_sums_kernel",
                                                "fold_and_halves_kernel")),
                          ("point_kernels", ("point_add_kernel", "point_double_kernel")),
                          ("ntt_kernels", ("ntt_phase1_kernel", "ntt_stage_kernel")),
                          ("transcript_kernels", ("keccak_f_kernel", "round_step_kernel")),
                          ("msm_kernels", tuple(f"{name}_kernel" for name in SCAN_PASSES)
                           + ("compact_add_kernel", "horner_kernel"))):
        for needle in needles:
            for line in resource_usage(_build.build_log[stem], needle):
                say(f"    {line}")
                if stem != "sumcheck_kernels" or "<W=8>" in line:  # W = 12: no path runs it
                    check("0 bytes spill stores" in line, f"{line.split(':')[0]} spills registers")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lib = fk.library()
    for name in fk._SUMMING:
        for w in (8, 12):
            n = fk._resident_blocks(lib, torch.device("cuda"), name, w)
            threads = (lib.zk_block_threads() if name == "gkr_round"
                       else lib.zk_sum_threads(fk._SUMMING[name], w))
            say(f"    {name} W = {w}: {threads} threads a block, {n} resident blocks "
                f"({n / sms:g} an SM)")
    peaks = roofline.chip_peaks()
    say(f"    peaks of the bounds (utils/roofline.py): {peaks.bytes_per_s:.4g} bytes/s, "
        f"{peaks.int32_mad_per_s:.4g} 32-bit multiply-adds/s")
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
    phase_path_times(ctx, poly)

    del poly
    torch.cuda.empty_cache()
    gctx = fb.get_ctx(BLS12_381_FR)
    say(f"[5] GKR path: 2^{GKR_NUM_VARS} inputs over BLS12-381 Fr, "
        "Circuit.evaluate -> prove_layers -> verify_layers")
    circuit, inputs, proved, gkr_launches = phase_gkr_main_path(gctx)

    say("[6] the GKR proof's ties")
    phase_gkr_ties(gctx, circuit, inputs, proved)

    say("[7] times")
    phase_gkr_times(gctx, circuit, inputs, proved)
    torch.cuda.empty_cache()
    times = phase_kernel_times(ctx)

    torch.cuda.empty_cache()
    say(f"[8] KZG path: the whole proof of the same 2^{GKR_NUM_VARS}-input circuit, "
        "gkr.protocol.prove -> gkr.protocol.verify")
    full_proof, taus, kzg_launches = phase_kzg_main_path(gctx, circuit, inputs, gkr_launches)

    say("[9] the input proof's ties")
    phase_kzg_ties(gctx, inputs, full_proof, taus, proved)

    say("[10] times of the KZG path")
    t_prove_single = phase_kzg_times(gctx, circuit, inputs, full_proof, taus)
    # phase 15 decodes this blob; of the proof it keeps what the host holds
    gkr_blob, gkr_encode_s = timed(lambda: ser.encode_gkr_proof(full_proof))
    kept = tampered(full_proof, kzg_setup=KZG(None, full_proof.input_proof.kzg_setup.g2_taus,
                                              GKR_NUM_VARS))
    del full_proof
    torch.cuda.empty_cache()
    point_times = phase_point_kernel_times()

    torch.cuda.empty_cache()
    say("[11] the two NTT kernels against their plain PyTorch versions (exact)")
    errs.update(phase_ntt_kernels_vs_plain())
    rctx = fb.get_ctx(BN254_FR)
    say(f"[12] NTT path: BN254 Fr, ntt forward and inverse at 2^{NTT_LOG_SIZES[0]} and "
        f"2^{NTT_LOG_SIZES[1]}, fft_evaluate -> fft_interpolate at 2^{NTT_LOG_SIZES[0]}")
    ntt_results, ntt_poly, ntt_evals, ntt_interp, ntt_launches = phase_ntt_main_path(rctx)
    phase_ntt_ties(rctx, ntt_results, ntt_poly, ntt_evals, ntt_interp)
    say("[13] times of the NTT path")
    ntt_times = phase_ntt_times(rctx, ntt_results)
    ntt_inputs = {log_n: r[0] for log_n, r in ntt_results.items()}
    ntt_outputs = {log_n: (r[0], r[2]) for log_n, r in ntt_results.items()}
    del ntt_results, ntt_evals, ntt_interp
    torch.cuda.empty_cache()
    phase_device_kernels(ctx, gctx)
    say("[14] each path once more under torch.profiler: the kernels' device time at real widths")
    scan_op_kernels()
    profiles = phase_profiles(ctx, gctx, rctx, circuit, inputs, taus, ntt_inputs, ntt_poly)
    check_one_launch(profiles)

    say("[15] proof bytes and the field oracle")
    t0 = time.time()
    reset_all_launches()
    phase_oracle()
    t_oracle = time.time() - t0
    phase_proof_bytes(proof, gkr_blob, gkr_encode_s, kept, circuit, proved)
    bytes_launches = all_launches()
    say(f"  launches in phase 15: {bytes_launches}; the oracle part {t_oracle:.1f}s, "
        f"the phase {time.time() - t0:.1f}s")

    say("[16] the mesh paths: one-process meshes of card slots")
    t0 = time.time()
    errs.update({name: max(errs[name], err)
                 for name, err in phase_batched_ntt_kernels_vs_plain().items()})
    mesh_launches = phase_mesh_paths(ctx, gctx, rctx, proof, circuit, inputs, taus, gkr_blob,
                                     kept.input_proof.commitment, ntt_outputs, t_prove_single)
    say(f"  launches in phase 16: {mesh_launches}; the phase {time.time() - t0:.1f}s")
    for name in nk.KERNEL_NAMES + mk.KERNEL_NAMES + ("mont_mul", "fold", "halves_sums",
                                                     "gkr_round", "point_add", "point_double"):
        check(mesh_launches[name] > 0, f"the mesh paths launched no {name}")

    say("[17] the transcript kernels, keccak_f and round_step, against their plain PyTorch "
        "versions (exact), and their times")
    transcript_errs, transcript_times = phase_transcript_kernels()
    errs.update(transcript_errs)

    say("[18] the MSM kernels, run_scan, compact_add and horner, against their plain PyTorch "
        "versions (exact), and their times at the KZG path's widths beside the eager chains "
        "they replace")
    msm_errs, msm_times = phase_msm_kernels(gctx, inputs, taus)
    errs.update(msm_errs)

    kernels = []
    for name in (fk.KERNEL_NAMES + pk.KERNEL_NAMES + nk.KERNEL_NAMES + tk.KERNEL_NAMES
                 + mk.KERNEL_NAMES):
        if name in pk.KERNEL_NAMES:
            rec, source = point_times[1 << GKR_NUM_VARS][name], POINT_KERNEL_SOURCE
        elif name in nk.KERNEL_NAMES:
            rec, source = ntt_times[NTT_LOG_SIZES[0]][name], NTT_KERNEL_SOURCE
        elif name in tk.KERNEL_NAMES:
            rec, source = transcript_times[name], TRANSCRIPT_KERNEL_SOURCE
        elif name in mk.KERNEL_NAMES:
            rec, source = msm_times[name], MSM_KERNEL_SOURCE
        else:
            rec, source = times[1 << NUM_VARS][name], KERNEL_SOURCE
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": REPLACES[name],
            "launches": (launches.get(name, 0) + gkr_launches.get(name, 0) + kzg_launches[name]
                         + ntt_launches[name] + bytes_launches[name] + mesh_launches[name]),
            "max_abs_err": errs[name], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"], "library_ms": None,
        })
    print_ranking(kernels, profiles)
    say(f"total {time.time() - t_start:.1f}s")
    say(gpu)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

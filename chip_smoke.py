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
     edge values and unreduced operands; the two G1 point kernels at widths 1,
     2, 33, 4096 and 2^20 with infinite, equal, opposite and re-scaled operands
     and coordinates 0 and p - 1 mixed in;
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
     each kernel's plain version and the least time the card could take;
  8. drives the third main path at full size: the whole GKR proof of the same
     2^20-input circuit with its multilinear-KZG input proof
     (``gkr.protocol.prove`` -> ``gkr.protocol.verify``: the SRS comb, the
     Pippenger MSMs of the commitment and of the 2 x 20 quotients, the host's
     pairings), reads the launch counts of all seven kernels, and refuses a
     tampered quotient point, commitment and opened evaluation;
  9. ties the input proof without a reference run: the taus are known, so the
     commitment, every quotient commitment and some SRS entries must be the
     host's scalar multiples of G1; the comb equals the ladder and Pippenger the
     bit-split MSM at 2^10; a 2^6 proof on the card equals the CPU's; the 2^5
     proof hashes to a stored digest;
 10. times the third path: ``prove`` warm with its stages, ``verify`` with the
     host's pairings apart, synchronising calls, peak device memory;
 11. holds the two NTT kernels against their plain versions on BN254 Fr tables
     with 0, 1, r - 1 and R mod r entries, forward and inverse twiddles:
     ``ntt_phase1`` at 1 to 2^22 entries, ``ntt_stage`` at every stage of 2^12,
     2^20 and 2^22; the card's twiddle table equals the CPU's;
 12. drives the fourth main path: ``ntt.ntt`` forward and inverse on 2^20- and
     2^22-entry tables (values below 2^256 from numpy seed 0, reduced by
     ``to_mont``), then ``fft_evaluate`` -> ``fft_interpolate`` at 2^20 through
     host ints; checks the launches of each call, the round trips, four outputs
     against the host's Horner evaluation, and the card's 2^12 transforms
     against the CPU's;
 13. times both NTT kernels at 2^20 and 2^22 beside their plain versions and
     bounds, the twiddle build, warm transforms, and ``fft_evaluate`` /
     ``fft_interpolate`` with their host packing apart.

Any failed comparison exits non-zero. The last line of the output is one JSON
object, ``{"ok": true, "device": {...}}``; the line before it lists the nine
kernels with their launch counts, errors, times and bounds.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from zktpu_torch import _build
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
from zktpu_torch.msm import fixed_base, generator_comb_mul, msm_bitsplit
from zktpu_torch.msm import pippenger as pp
from zktpu_torch.ntt import ntt as tn
from zktpu_torch.ntt import ntt_kernels as nk
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
POINT_CHECK_WIDTHS = (1, 2, 33, 4096, 1 << 20)
POINT_TIME_WIDTHS = (1 << 16, 1 << 20)
TIME_SIZES = (1 << 20, 1 << 24)
TIMED_RUNS = 10

#: the NTT path: BN254 Fr tables of 2^20 and 2^22 entries (bench.py:328-330);
#: fft_evaluate / fft_interpolate at the first size
NTT_LOG_SIZES = (20, 22)
#: ntt_phase1 against its plain version at these sizes (log2), and ntt_stage at
#: these (log2 size, stages)
NTT_PHASE1_CHECK_LOGS = (0, 1, 3, 10, 12, 20, 22)
NTT_STAGE_CHECKS = tuple((log_n, tuple(range(1, log_n + 1))) for log_n in (12, 20, 22))
NTT_CPU_TIE_LOG = 12

# Peaks of one H100 SXM used for the bounds. Memory: 3.35 TB/s (data sheet).
# Integer: 132 SMs x 64 INT32 lanes x 1.98 GHz boost = 16.7e12 32-bit
# multiply-adds a second; a 32x32->64 multiply-accumulate is two of them (low
# and high half).
HBM_BYTES_PER_S = 3.35e12
INT32_MAD_PER_S = 132 * 64 * 1.98e9

KERNEL_SOURCE = "zktpu_torch/csrc/sumcheck_kernels.cu"
POINT_KERNEL_SOURCE = "zktpu_torch/csrc/point_kernels.cu"
NTT_KERNEL_SOURCE = "zktpu_torch/csrc/ntt_kernels.cu"
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
}
#: launches the main path must make at 2^NUM_VARS. mont_mul: to_mont of the table,
#: from_mont of each round's two sums, to_mont of each later round's challenge,
#: and the verifier's to_mont of the point and from_mont of the evaluation; then
#: round 0, rounds 1..n-1, the verifier's n folds
EXPECTED_LAUNCHES = {
    "mont_mul": 1 + NUM_VARS + (NUM_VARS - 1) + 2,
    "halves_sums": 1,
    "fold_and_halves": NUM_VARS - 1,
    "fold": NUM_VARS,
    "gkr_round": 0,
}


def gkr_expected_launches(n: int) -> dict[str, int]:
    """Launches of ``prove_layers`` (lazy, fused) + ``verify_layers`` (lazy) on a
    halving circuit of 2^n inputs. The layer whose inputs have j variables
    (j = 1..n) runs 2j rounds.

    gkr_round: one a round, n(n+1) in all.
    fold: one a round; j for each of the layer's two input evaluations; one for
    the output polynomial's evaluation, in the prover and again in the verifier.
    mont_mul, prover: a round makes 3 (the sums' canonical form, the division by
    two of the interpolation, the challenge into Montgomery form); a layer adds
    2 + 3 for the phase tables, 2 for the gate masks, 2j for eq(r_b, .), 1 for
    the challenges' upload, 4(j-1) + 2 + 1 for the folded wiring coefficients
    (3 at the output layer) and 4 for the two evaluations: 12j + 11. The walk
    adds 1 for the inputs, n for the circuit, 3 for the output polynomial.
    mont_mul, verifier: a layer makes 4(j-1) + 5 for the coefficients (5 at the
    output layer), 4j + 1 for the two eq tables, 3 for the weights, 1 for the
    two sums: 8j + 6; the walk adds 2 for the output polynomial.
    """
    rounds = n * (n + 1)
    prover_mul = 6 * rounds + 11 * n + 1 + n + 3
    verifier_mul = 4 * rounds + 6 * n + 2
    return {
        "mont_mul": prover_mul + verifier_mul,
        "fold": rounds + rounds + 1 + 1,
        "gkr_round": rounds,
        "halves_sums": 0,
        "fold_and_halves": 0,
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
    return worst


# ----------------------------------------------------------------------
# phases 3 and 4: the main path and its tie to the reference
# ----------------------------------------------------------------------

def phase_main_path(ctx):
    values = benchmark_values(NUM_VARS)
    torch.cuda.synchronize()
    fk.reset_launches()
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
    launches = dict(fk.launches)
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
    t0 = time.time()
    proved = gkr.prove_layers(circuit, inputs)
    torch.cuda.synchronize()
    t_prove = time.time() - t0
    t0 = time.time()
    verdict = gkr.verify_layers(proved.proof, circuit, proved.input_evals)
    torch.cuda.synchronize()
    t_verify = time.time() - t0
    launches = dict(fk.launches)
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

def time_events(fn, runs: int, flush=None) -> float:
    """Median milliseconds of ``fn`` over ``runs`` launches, by CUDA events;
    ``flush`` (a tensor larger than the L2 cache) is rewritten before each."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(runs):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def kernel_work(name: str, size: int, w: int):
    """(bytes moved, 32-bit multiply-adds) of one call at ``size``:
    each input read once, each output written once."""
    elem = 4 * w
    mul = 2 * (2 * w * w + w)  # one Montgomery product, low and high halves
    if name == "mont_mul":  # table x one element
        return 2 * size * elem + elem, size * mul
    if name == "fold":
        return size * elem + size // 2 * elem + elem, size // 2 * mul
    rows = 2 * 4 * (w + fk.EXTRA_WORDS)
    if name == "halves_sums":  # a 64-bit column add is two 32-bit adds
        return size * elem + rows, size * 2 * w
    if name == "fold_and_halves":
        return size * elem + size // 2 * elem + elem + rows, size // 2 * (mul + 2 * w)
    if name == "gkr_round":  # a (2, 2, size, W) stack: six products and three terms an index
        return 4 * size * elem + 3 * rows // 2, size // 2 * (6 * mul + 3 * 2 * w)
    raise ValueError(name)


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
        nbytes, mads = kernel_work(name, size, ctx.num_words)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = mads / INT32_MAD_PER_S * 1e3
        rec = {
            "ms": cold, "warm_ms": warm, "plain_ms": plain_ms, "bytes": nbytes,
            "gb_per_s": nbytes / (cold * 1e-3) / 1e9,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        }
        out[name] = rec
        say(f"  {name} 2^{size.bit_length() - 1}: {cold:.4f} ms cold L2 "
            f"({rec['gb_per_s']:.0f} GB/s of {nbytes} bytes), {warm:.4f} ms warm, "
            f"plain {plain_ms:.2f} ms, bound {rec['bound_ms']:.4f} ms by {rec['bound_by']} "
            f"(bytes {t_bytes:.4f} ms, operations {t_ops:.4f} ms)")
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

    state = torch.arange(25, dtype=torch.int64, device=ctx.device)
    rows = torch.ones((2, ctx.num_words + fk.EXTRA_WORDS), dtype=torch.int32, device=ctx.device)
    ms_keccak = host_ms(lambda: kd.keccak_f(state))
    ms_digest = host_ms(lambda: fused._digest_to_mont(ctx, state[:4]))
    ms_canon = host_ms(lambda: fused._canonicalize_rows(ctx, rows))
    # one keccak-f per round, plus the extra blocks of round 0's longer absorb
    sponge = poly.transcript_sponge()
    sponge.absorb(vec_to_bytes(ctx.spec, [0]))
    tail_len = len(sponge.state_lanes()[1])
    n_keccak = NUM_VARS - 1 + (tail_len + fused.ROUND_ELEMS * ctx.spec.byte_len) // kd.RATE + 1
    share = n_keccak * ms_keccak / (t_prove * 1e3)
    say(f"  eager device glue of the prover, per call (host clock): keccak_f {ms_keccak:.3f} ms, "
        f"_digest_to_mont {ms_digest:.3f} ms, _canonicalize_rows {ms_canon:.3f} ms")
    say(f"  keccak_f share of the warm prover: {n_keccak} calls x {ms_keccak:.3f} ms = "
        f"{n_keccak * ms_keccak:.2f} ms of {t_prove * 1e3:.2f} ms = {share:.1%}; "
        f"scalar field glue {(NUM_VARS - 1) * ms_digest + NUM_VARS * ms_canon:.2f} ms")



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
    consts = fused_lazy._PhaseConsts(ctx, np.zeros(25, np.int64), np.zeros(4, np.int64))
    canon = fused._canonicalize_rows(ctx, rows)
    ms_keccak = host_ms(lambda: kd.keccak_f(state))
    ms_canon = host_ms(lambda: fused._canonicalize_rows(ctx, rows))
    ms_interp = host_ms(lambda: fused_lazy._interp3(ctx, canon, consts.inv2))
    ms_digest = host_ms(lambda: fused._digest_to_mont(ctx, state[:4]))
    # one permutation a round, and a spare one where the first absorb of a phase
    # may cross a block (the output layer's first phase: 64 pending bytes)
    n_keccak = n * (n + 1) + 1
    say(f"  eager glue of a fused round, per call (host clock): keccak_f {ms_keccak:.3f} ms, "
        f"_interp3 {ms_interp:.3f} ms, _canonicalize_rows {ms_canon:.3f} ms, "
        f"_digest_to_mont {ms_digest:.3f} ms")
    rounds = n * (n + 1)
    alone = {"keccak_f": n_keccak * ms_keccak, "_interp3": rounds * ms_interp,
             "_canonicalize_rows": rounds * ms_canon, "_digest_to_mont": rounds * ms_digest}
    total = sum(alone.values())
    say(f"  those calls of a proof, timed alone: {total / 1e3:.3f} s against {t_prove:.3f} s for "
        f"the whole warm prove_layers (the host's speed drifts between the two); in "
        f"proportion: " + ", ".join(f"{k} {v / total:.1%}" for k, v in alone.items()))


def phase_gkr_launches_a_round(ctx) -> None:
    """One fused layer alone, small enough for the profiler: the eager launches
    of a round. Runs last: once the profiler has been on, every later launch in
    the process costs the host more."""
    n = GKR_NUM_VARS
    rng = np.random.default_rng(3)
    w_vars = 6
    layer_inputs = [int(v) for v in rng.integers(0, 1 << 61, size=1 << w_vars)]
    w_poly = MultilinearPoly.from_ints(ctx, layer_inputs)
    fbc = gkr_lazy.LazyFbc(
        ctx, gkr_lazy._encode(ctx, list(range(1, 1 + (1 << (w_vars - 1))))),
        gkr_lazy._encode(ctx, list(range(7, 7 + (1 << (w_vars - 1))))), w_poly)
    transcript = Transcript(ctx.spec)
    transcript.append_field_elements([1])
    kernels = count_device_kernels(
        lambda: fused_lazy.gkr_prove_lazy_fused(0, fbc, copy.deepcopy(transcript)))
    rounds = 2 * w_vars
    say(f"  one fused layer of {rounds} rounds ({1 << w_vars} inputs): {kernels} device kernels, "
        f"{kernels / rounds:.0f} a round; at that rate the {n * (n + 1)} rounds of a "
        f"2^{n} proof launch about {kernels / rounds * n * (n + 1):.0f}")


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
    each operand infinite, both infinite, coordinates 0 and p - 1."""
    n = p1[0].shape[0]
    p = fq.spec.modulus
    p1 = tuple(t.clone() for t in p1)
    p2 = tuple(t.clone() for t in p2)
    other_form = rescale_points(fq, p1, random_table(fq, rng, n))
    neg_y = fb.sub(fq, torch.zeros_like(p1[1]), p1[1])
    # two rows of raw coordinates: (0, p - 1, p - 1) and (0, 1, p - 1)
    raw = tuple(random_table(fq, rng, 2, edges=pair) for pair in ((0, 0), (p - 1, 1), (p - 1, p - 1)))

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
        errs = {
            "point_add": triple_err(pk.point_add(fq, p1, p2), pk.point_add_plain(fq, p1, p2)),
            "point_double": triple_err(pk.point_double(fq, p1), pk.point_double_plain(fq, p1)),
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
        say(f"  bls12_381_fq width {n}: " + " ".join(f"{k}={v}" for k, v in errs.items()))
        for name, err in errs.items():
            check(err == 0, f"{name} differs from its plain version (width {n})")
            worst[name] = max(worst[name], err)
    return worst


def point_kernel_work(name: str, n: int):
    """(bytes moved, 32-bit multiply-adds) of one call over n lanes of finite,
    unequal points: an addition reads six and writes three 48-byte coordinates
    for 16 Montgomery products, a doubling three and three for 7. The modular
    additions and subtractions (no products) are not counted."""
    mul = 2 * (2 * 12 * 12 + 12)
    if name == "point_add":
        return 9 * 48 * n, 16 * mul * n
    if name == "point_double":
        return 6 * 48 * n, 7 * mul * n
    raise ValueError(name)


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
            nbytes, mads = point_kernel_work(name, n)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = mads / INT32_MAD_PER_S * 1e3
            rec = {"ms": cold, "warm_ms": warm, "plain_ms": plain_ms,
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
            out[n][name] = rec
            say(f"  {name} 2^{n.bit_length() - 1} lanes: {cold:.4f} ms cold L2, {warm:.4f} ms warm, "
                f"plain {plain_ms:.2f} ms, bound {rec['bound_ms']:.4f} ms by {rec['bound_by']} "
                f"(bytes {t_bytes:.4f} ms, operations {t_ops:.4f} ms)")
    # mont_mul at W = 12, the word count of this path's field
    for n in POINT_TIME_WIDTHS:
        table = random_table(fq, rng, n)
        cold = time_events(lambda: fk.mont_mul(fq, table, fq.r2), TIMED_RUNS, flush)
        plain_ms = time_events(lambda: fk.mont_mul_plain(fq, table, fq.r2), 3, flush)
        nbytes, mads = kernel_work("mont_mul", n, 12)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, mads / INT32_MAD_PER_S * 1e3
        say(f"  mont_mul W=12 2^{n.bit_length() - 1}: {cold:.4f} ms cold L2, plain {plain_ms:.2f} ms, "
            f"bound {max(t_bytes, t_ops):.4f} ms (bytes {t_bytes:.4f} ms, operations {t_ops:.4f} ms)")
    return out


# ----------------------------------------------------------------------
# phases 8 to 10: the whole GKR proof with its KZG input proof
# ----------------------------------------------------------------------

def reset_all_launches() -> None:
    fk.reset_launches()
    pk.reset_launches()
    nk.reset_launches()


def all_launches() -> dict[str, int]:
    return {**fk.launches, **pk.launches, **nk.launches}


def kzg_expected_doublings(n: int) -> int:
    """point_double launches of ``prove`` at 2^n inputs: every Pippenger call
    makes 256 - c in its Horner chain (c the window it picked) and none
    elsewhere; the commitment is one call over 2^n points, and step k of the two
    openings one batched call of two segments over 2^(n-1-k). The comb's table
    is built before the path is driven."""
    doublings = 256 - pp.pick_window_bits(1 << n)
    for k in range(n):
        doublings += 256 - pp.pick_window_bits_multi(2, 1 << (n - 1 - k))
    return doublings


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
    want = kzg_expected_doublings(n)
    check(prove_launches["point_double"] == want == launches["point_double"],
          f"point_double launches {prove_launches['point_double']} != {want}")
    # the comb's 31 additions, the n folds of the basis chain, and in each of the
    # 1 + n Pippenger calls at least one compaction round, the densifying round
    # and the Horner chain's additions; the compaction's round count follows the data
    check(prove_launches["point_add"] >= 31 + n + (1 + n) * (2 + 256 // 16 - 1),
          f"too few point_add launches: {prove_launches['point_add']}")
    walk = gkr_expected_launches(n)
    check(all(launches[name] >= walk[name] for name in walk),
          "the full proof launched the layer walk's kernels less often than the walk alone")
    check(launches["gkr_round"] == walk["gkr_round"] == layers_launches["gkr_round"],
          "gkr_round launches differ from the layer walk's")

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
        before = pk.launches["point_double"]
        got = pp.msm_pippenger(comb, weights, c)
        check(pk.launches["point_double"] - before == 256 - c, f"Horner doublings at c={c}")
        check(dc.unpack_points(tuple(t[None] for t in got)) == bitsplit,
              f"Pippenger (c={c}) != bit-split at {lanes} points")
    say(f"  Pippenger (c in {MSM_TIE_WINDOWS}) == bit-split MSM at {lanes} points; "
        "256 - c doublings a call")

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


def phase_kzg_times(ctx, circuit, inputs, proof, taus) -> None:
    n = GKR_NUM_VARS
    proves = []
    for _ in range(3):
        again, t = timed(lambda: gkr.prove(circuit, inputs, taus=taus))
        proves.append(t)
    check(same_input_proof(again.input_proof, proof.input_proof), "a warm proof differs from the first")
    say(f"  warm GKR 2^{n} inputs: prove {statistics.median(proves):.4f}s (median of 3, host clock, "
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
    total = t_walk + t_setup + t_open + t_commit + t_chain + t_quot + t_msms
    say(f"  stages of prove, each alone: layer walk {t_walk:.3f}s, KZG set-up (eq table, comb, "
        f"g2 taus on the host) {t_setup:.3f}s, opens {t_open:.3f}s, commit MSM {t_commit:.3f}s, "
        f"basis chain {t_chain:.3f}s, quotient tables {t_quot:.3f}s, quotient MSMs {t_msms:.3f}s; "
        f"sum {total:.3f}s")

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
            tiles = {min(nk.LOG_TILE, log_n)} | ({4} if log_n == NTT_CPU_TIE_LOG else set())
            for log_tile in sorted(tiles):
                err = max_abs_err(nk.ntt_phase1(ctx, x, tws[log_n], log_tile),
                                  nk.ntt_phase1_plain(ctx, x, tws[log_n], log_tile))
                note("ntt_phase1", err, f"2^{log_n}, tile 2^{log_tile}, inverse={inverse}")
                errs.append(f"2^{log_n}/{log_tile}={err}")
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
        say(f"  bn254_fr {'inverse' if inverse else 'forward'}: ntt_phase1 (2^log_n/log tile=err) "
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


def ntt_kernel_work(name: str, log_n: int, stage: int = 0):
    """(bytes moved, 32-bit multiply-adds) of one call on a 2^log_n table: the
    table read once and written once, the distinct twiddles read once (T/2 for
    phase 1 at tile T, m/2 for the stage of span m), one Montgomery product a
    butterfly whose twiddle is not w^0 = 1 (the stage of span m has n/m
    butterflies by 1, which need none); modular adds and subtractions not
    counted."""
    n, elem, mul = 1 << log_n, 32, 2 * (2 * 8 * 8 + 8)
    if name == "ntt_phase1":
        log_tile = min(nk.LOG_TILE, log_n)
        products = sum(n // 2 - (n >> s) for s in range(1, log_tile + 1))
        return 2 * n * elem + (1 << log_tile) // 2 * elem, products * mul
    if name == "ntt_stage":
        return 2 * n * elem + (1 << (stage - 1)) * elem, (n // 2 - (n >> stage)) * mul
    raise ValueError(name)


def ntt_record(cold, warm, plain_ms, nbytes, mads) -> dict:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, mads / INT32_MAD_PER_S * 1e3
    return {"ms": cold, "warm_ms": warm, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes, "ops_ms": t_ops}


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
            *ntt_kernel_work("ntt_phase1", log_n))
        recs["ntt_phase1"] = rec
        say(f"  ntt_phase1 2^{log_n}: {rec['ms']:.4f} ms cold L2, {rec['warm_ms']:.4f} ms warm, "
            f"plain {rec['plain_ms']:.2f} ms, bound {rec['bound_ms']:.4f} ms by {rec['bound_by']} "
            f"(bytes {rec['bytes_ms']:.4f} ms, operations {rec['ops_ms']:.4f} ms)")
        stage_recs = []
        for stage in range(log_tile + 1, log_n + 1):
            rec = ntt_record(
                time_events(lambda: nk.ntt_stage(ctx, x, tw, stage), TIMED_RUNS, flush),
                time_events(lambda: nk.ntt_stage(ctx, x, tw, stage), TIMED_RUNS),
                time_events(lambda: nk.ntt_stage_plain(ctx, x, tw, stage), 3, flush),
                *ntt_kernel_work("ntt_stage", log_n, stage))
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
        bound = recs["ntt_phase1"]["bound_ms"] + sum(r["bound_ms"] for r in stage_recs)
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


def print_ranking(kernels: list[dict]) -> None:
    """The nine kernels by launches on the main paths x (ms - bound_ms), at the
    size of each row of the kernels line."""
    ranked = sorted(kernels, key=lambda k: -k["launches"] * (k["ms"] - k["bound_ms"]))
    say("  kernels by launches x (ms - bound_ms): " + "; ".join(
        f"{k['name']} {k['launches']} x ({k['ms']:.4f} - {k['bound_ms']:.4f}) = "
        f"{k['launches'] * (k['ms'] - k['bound_ms']):.1f} ms" for k in ranked))


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
    _build.build_cuda_libraries(["sumcheck_kernels", "point_kernels", "ntt_kernels"])
    fk.library()
    pk.library()
    nk.library()
    say(f"    kernels built from {KERNEL_SOURCE} ({_build.build_seconds['sumcheck_kernels']:.1f}s), "
        f"{POINT_KERNEL_SOURCE} ({_build.build_seconds['point_kernels']:.1f}s) and "
        f"{NTT_KERNEL_SOURCE} ({_build.build_seconds['ntt_kernels']:.1f}s), side by side "
        f"in {time.time() - t0:.1f}s (0.0 = already built)")
    for stem, needles in (("sumcheck_kernels", ("gkr_round_kernel",)),
                          ("point_kernels", ("point_add_kernel", "point_double_kernel")),
                          ("ntt_kernels", ("ntt_phase1_kernel", "ntt_stage_kernel"))):
        for needle in needles:
            for line in resource_usage(_build.build_log[stem], needle):
                say(f"    {line}")
    say(f"    host Keccak backend: {hk.backend()}")
    check(hk.backend() == "c", "the host Keccak fell back to pure Python")

    say("[2] each kernel against its plain PyTorch version (exact)")
    errs = phase_kernels_vs_plain()
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
    phase_kzg_times(gctx, circuit, inputs, full_proof, taus)
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
    del ntt_results, ntt_poly, ntt_evals, ntt_interp
    torch.cuda.empty_cache()
    phase_gkr_launches_a_round(gctx)

    kernels = []
    for name in fk.KERNEL_NAMES + pk.KERNEL_NAMES + nk.KERNEL_NAMES:
        if name in pk.KERNEL_NAMES:
            rec, source = point_times[1 << GKR_NUM_VARS][name], POINT_KERNEL_SOURCE
        elif name in nk.KERNEL_NAMES:
            rec, source = ntt_times[NTT_LOG_SIZES[0]][name], NTT_KERNEL_SOURCE
        else:
            rec, source = times[1 << NUM_VARS][name], KERNEL_SOURCE
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": REPLACES[name],
            "launches": (launches.get(name, 0) + gkr_launches.get(name, 0) + kzg_launches[name]
                         + ntt_launches[name]),
            "max_abs_err": errs[name], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"], "library_ms": None,
        })
    print_ranking(kernels)
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

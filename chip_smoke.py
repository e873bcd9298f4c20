#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``zktpu_torch``): run it on one GPU.

    python3 chip_smoke.py

It needs one CUDA device and ``nvcc``; with no card it exits non-zero at once.
It builds the CUDA kernels from ``zktpu_torch/csrc/``, then

  1. prints the card's name and power limit, the build time and the host Keccak
     backend (the pure-Python one is refused);
  2. holds each kernel against its plain PyTorch version on the card, word for
     word (tolerance 0: this is integer arithmetic), for BN254 Fq and BLS12-381
     Fr at sizes from 2 to 2^20 and BLS12-381 Fq (12 words) up to 4096, with
     edge values and unreduced operands;
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
  7. times both paths and each kernel (CUDA events, median), beside each
     kernel's plain version and the least time the card could take.

Any failed comparison exits non-zero. The last line of the output is one JSON
object, ``{"ok": true, "device": {...}}``; the line before it lists the kernels
with their launch counts, errors, times and bounds.
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
from zktpu_torch.field import kernels as fk
from zktpu_torch.field import torch_backend as fb
from zktpu_torch.field.host import vec_to_bytes
from zktpu_torch.field.spec import BLS12_381_FQ, BLS12_381_FR, BN254_FQ
from zktpu_torch.gkr import fused_lazy
from zktpu_torch.gkr import lazy as gkr_lazy
from zktpu_torch.gkr import protocol as gkr
from zktpu_torch.gkr.circuit import ADD, MUL, Circuit
from zktpu_torch.hash import keccak as hk
from zktpu_torch.hash import keccak_device as kd
from zktpu_torch.poly.multilinear import MultilinearPoly
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

CHECK_SIZES = (2, 4, 64, 4096, 1 << 20)
TIME_SIZES = (1 << 20, 1 << 24)
TIMED_RUNS = 10

# Peaks of one H100 SXM used for the bounds. Memory: 3.35 TB/s (data sheet).
# Integer: 132 SMs x 64 INT32 lanes x 1.98 GHz boost = 16.7e12 32-bit
# multiply-adds a second; a 32x32->64 multiply-accumulate is two of them (low
# and high half).
HBM_BYTES_PER_S = 3.35e12
INT32_MAD_PER_S = 132 * 64 * 1.98e9

KERNEL_SOURCE = "zktpu_torch/csrc/sumcheck_kernels.cu"
REPLACES = {
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


def gkr_benchmark(num_vars: int):
    """A halving circuit of 2^num_vars inputs and 2^num_vars - 1 random add/mul
    gates, and inputs below 2^61, from numpy seed 7: (structure, inputs)."""
    rng = np.random.default_rng(7)
    structure = []
    n = 1 << (num_vars - 1)
    while n >= 1:
        structure.append([ADD if bit else MUL for bit in rng.integers(2, size=n)])
        n //= 2
    inputs = [int(v) for v in rng.integers(0, 1 << 61, size=1 << num_vars)]
    return structure, inputs


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
    holds ``needle``: the template's word count, then ptxas's own two lines."""
    lines = log.splitlines()
    out = []
    for i, line in enumerate(lines):
        if "Function properties for" in line and needle in line:
            words = line.split(needle + "ILi")[1].split("E")[0]
            out.append(f"{needle}<W={words}>: {lines[i + 1].strip()}; "
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

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    t_start = time.time()
    gpu = gpu_line()
    say(f"[1] device: {gpu}")
    say(f"    torch {torch.__version__}, CUDA {torch.version.cuda}")
    fk.library()
    say(f"    kernels built from {KERNEL_SOURCE} in "
        f"{_build.build_seconds['sumcheck_kernels']:.1f}s (0.0 = already built)")
    for line in resource_usage(_build.build_log["sumcheck_kernels"], "gkr_round_kernel"):
        say(f"    {line}")
    say(f"    host Keccak backend: {hk.backend()}")
    check(hk.backend() == "c", "the host Keccak fell back to pure Python")

    say("[2] each kernel against its plain PyTorch version (exact)")
    errs = phase_kernels_vs_plain()

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
    phase_gkr_launches_a_round(gctx)

    kernels = []
    for name in fk.KERNEL_NAMES:
        rec = times[1 << NUM_VARS][name]
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES[name], "launches": launches[name] + gkr_launches[name],
            "max_abs_err": errs[name], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"], "library_ms": None,
        })
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

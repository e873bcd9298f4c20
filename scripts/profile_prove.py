#!/usr/bin/env python3
"""Where the provers and verifiers spend their time on the card.

Run on a machine with one CUDA device, from the repo's root:

    python3 scripts/profile_prove.py [--num-vars 20]         # the plain sumcheck
    python3 scripts/profile_prove.py --gkr [--num-vars 20]   # the GKR layer walk

Sumcheck: (1) host-clock times of the prover's stages, each closed by a
synchronise, and (2) a ``torch.profiler`` summary of one warm prove and one warm
verify: the number of device kernels launched, their summed device time, the
device's idle share of the wall time, and the kernels that take most of it.

GKR: the stages of the input layer's fused sumcheck one by one, the whole walk
layer by layer (the ``ZKTPU_TRACE`` marks of ``prove_layers``), the verifier's
time, and a profiler summary of one small fused layer.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke  # noqa: E402
from zktpu_torch.field import torch_backend as fb  # noqa: E402
from zktpu_torch.field.host import vec_to_bytes  # noqa: E402
from zktpu_torch.field.spec import BLS12_381_FR, BN254_FQ  # noqa: E402
from zktpu_torch.gkr import fused_lazy  # noqa: E402
from zktpu_torch.gkr import lazy as gkr_lazy  # noqa: E402
from zktpu_torch.gkr import protocol as gkr  # noqa: E402
from zktpu_torch.gkr.circuit import Circuit  # noqa: E402
from zktpu_torch.hash import keccak_device as kd  # noqa: E402
from zktpu_torch.poly.multilinear import MultilinearPoly  # noqa: E402
from zktpu_torch.sumcheck import fused, protocol  # noqa: E402
from zktpu_torch.transcript import Transcript  # noqa: E402


def timed(label: str, fn):
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    print(f"  {label}: {(time.time() - t0) * 1e3:.2f} ms", flush=True)
    return out


def prover_stages(poly) -> None:
    """The steps of ``fused.prove``, one by one."""
    ctx = poly.ctx
    claimed = timed("host: canonical table + exact column sum",
                    lambda: fused.host_sum_mod_p(ctx, poly.canonical_table()))

    def sponge_state():
        sponge = poly.transcript_sponge()
        sponge.absorb(vec_to_bytes(ctx.spec, [claimed]))
        return sponge.state_lanes()

    pairs, tail = timed("host: cached sponge copy + claimed sum", sponge_state)
    rows = timed(
        "device: all rounds (_device_prove)",
        lambda: fused._device_prove(
            ctx, poly.num_vars, kd.pairs_to_lanes(pairs), kd.bytes_to_lanes(tail), poly.table
        ),
    )
    timed("fetch + unpack of the round polynomials",
          lambda: [int(v) for v in ctx.unpack(rows.reshape(-1, ctx.num_words))])


def profiled(label: str, fn) -> None:
    torch.cuda.synchronize()
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1e3
    kernels = [
        e for e in prof.key_averages()
        if e.device_type.name == "CUDA" and e.device_time_total > 0
    ]
    launches = sum(e.count for e in kernels)
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    print(f"  {label}: wall {wall_ms:.2f} ms under the profiler, {launches} device kernels, "
          f"device busy {busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.1%}", flush=True)
    if not kernels:
        print("  (the profiler recorded no device time on this machine)")
        return
    for e in sorted(kernels, key=lambda e: -e.device_time_total)[:8]:
        print(f"    {e.device_time_total / 1e3:9.3f} ms  x{e.count:<6d} {e.key[:90]}")


def gkr_layer_stages(ctx, w_poly, layer) -> None:
    """The steps of one layer's fused sumcheck (``lazy_folded_fbc`` ->
    ``gkr_prove_lazy_fused``) and of its two input evaluations, one by one."""
    k = w_poly.num_vars - 1
    point = list(range(3, 3 + k))
    fbc = timed("wiring coefficients (lazy_folded_fbc: 2 eq tables, masks)",
                lambda: gkr_lazy.lazy_folded_fbc(ctx, layer, w_poly, point, point[::-1], 5, 7))
    transcript = Transcript(ctx.spec)
    transcript.append_field_elements([1])
    gh = timed("phase-1 tables G, H",
               lambda: gkr_lazy._phase1_tables_kernel(ctx, fbc.coef_a, fbc.coef_m, fbc.w_table))
    ones = ctx.one_mont.expand(fbc.w_table.shape)
    tables1 = timed("phase-1 stack [[F, G], [H, 1]]", lambda: torch.stack(
        [torch.stack([fbc.w_table, gh[0]]), torch.stack([gh[1], ones])]))
    _, challenges, wb = timed(f"phase 1: {k + 1} rounds on the device + fetch + host replay",
                              lambda: fused_lazy._run_phase(ctx, transcript, tables1))
    eqb = timed("eq(r_b, .) table",
                lambda: gkr_lazy.eq_tensor(ctx, gkr_lazy._encode(ctx, challenges)))
    tables2 = timed("phase-2 stack", lambda: gkr_lazy._phase2_tables_kernel(
        ctx, fbc.coef_a, fbc.coef_m, fbc.w_table, eqb, wb))
    timed(f"phase 2: {k + 1} rounds on the device + fetch + host replay",
          lambda: fused_lazy._run_phase(ctx, transcript, tables2))
    timed("the two input evaluations w(r_b), w(r_c)",
          lambda: (w_poly.evaluate_int(challenges), w_poly.evaluate_int(challenges[::-1])))


def gkr_mode(num_vars: int) -> int:
    ctx = fb.get_ctx(BLS12_381_FR)
    structure, inputs = chip_smoke.gkr_benchmark(num_vars)
    circuit = Circuit(ctx, structure)
    input_poly = timed("inputs upload (from_ints)", lambda: MultilinearPoly.from_ints(ctx, inputs))
    timed("circuit evaluation", lambda: circuit.evaluate(input_poly))
    proved = gkr.prove_layers(circuit, inputs)  # warm: builds the kernels
    assert gkr.verify_layers(proved.proof, circuit, proved.input_evals).verified

    print(f"stages of the input layer's sumcheck (2^{num_vars} w-entries; host clock, synchronised):")
    gkr_layer_stages(ctx, input_poly, circuit.layers[0])

    print("the whole walk, layer by layer (marks on stderr follow):", flush=True)
    os.environ["ZKTPU_TRACE"] = "1"
    try:
        timed("whole prove_layers", lambda: gkr.prove_layers(circuit, inputs))
    finally:
        del os.environ["ZKTPU_TRACE"]
    timed("whole verify_layers",
          lambda: gkr.verify_layers(proved.proof, circuit, proved.input_evals))

    print("torch.profiler, one fused layer of 2^6 w-entries (12 rounds):")
    small = MultilinearPoly(ctx, input_poly.table[:64].contiguous())
    small_circuit = Circuit(ctx, [structure[-6]])
    fbc = gkr_lazy.lazy_folded_fbc(
        ctx, small_circuit.layers[0], small, [3, 4, 5, 6, 7], [7, 6, 5, 4, 3], 5, 7)
    transcript = Transcript(ctx.spec)
    transcript.append_field_elements([1])
    profiled("gkr_prove_lazy_fused", lambda: fused_lazy.gkr_prove_lazy_fused(0, fbc, transcript))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--num-vars", type=int, default=20)
    ap.add_argument("--gkr", action="store_true", help="profile the GKR layer walk")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_prove: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    if args.gkr:
        return gkr_mode(args.num_vars)
    ctx = fb.get_ctx(BN254_FQ)
    poly = MultilinearPoly.from_ints(ctx, chip_smoke.benchmark_values(args.num_vars))
    proof = fused.prove(poly)  # warm: builds the kernels, caches the host sponge
    assert protocol.verify(poly, proof)

    print(f"prover stages at 2^{args.num_vars} (host clock, synchronised):")
    prover_stages(poly)
    timed("whole fused.prove", lambda: fused.prove(poly))
    timed("whole protocol.verify", lambda: protocol.verify(poly, proof))
    print("torch.profiler:")
    profiled("fused.prove", lambda: fused.prove(poly))
    profiled("protocol.verify", lambda: protocol.verify(poly, proof))
    return 0


if __name__ == "__main__":
    sys.exit(main())

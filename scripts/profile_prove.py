#!/usr/bin/env python3
"""Where the 2^20 sumcheck prover and verifier spend their time on the card.

Run on a machine with one CUDA device, from the repo's root:

    python3 scripts/profile_prove.py [--num-vars 20]

It prints (1) host-clock times of the prover's stages, each closed by a
synchronise, and (2) a ``torch.profiler`` summary of one warm prove and one warm
verify: the number of device kernels launched, their summed device time, the
device's idle share of the wall time, and the kernels that take most of it.
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
from zktpu_torch.field.spec import BN254_FQ  # noqa: E402
from zktpu_torch.hash import keccak_device as kd  # noqa: E402
from zktpu_torch.poly.multilinear import MultilinearPoly  # noqa: E402
from zktpu_torch.sumcheck import fused, protocol  # noqa: E402


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--num-vars", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_prove: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
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

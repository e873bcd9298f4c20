"""The window of one caller that proves back to back, each proof to its end:
from the first proof's start until the first proof that ends after the
window's seconds. ``prove_s`` is the window's seconds over the proofs."""

from __future__ import annotations

import time


def window(prove, pool: list, seconds: float, sync) -> tuple[list, dict]:
    """(the proofs, the window as a generator's ``window`` returns it);
    proof i is ``prove(pool[i % len(pool)])``, then ``sync()``."""
    sync()
    proofs, ends, cpu = [], [], [time.thread_time()]
    start = time.time_ns()
    while True:
        proofs.append(prove(pool[len(proofs) % len(pool)]))
        sync()
        ends.append(time.time_ns())
        cpu.append(time.thread_time())
        if ends[-1] - start >= seconds * 1e9:
            break
    end = ends[-1]
    return proofs, {
        "start_ns": start, "end_ns": end, "attempted": len(proofs), "units": len(proofs),
        "durations_s": [(b - a) / 1e9 for a, b in zip([start] + ends, ends)],
        "main_cpu_s": [b - a for a, b in zip(cpu, cpu[1:])],
        "metrics": {"prove_s": (end - start) / 1e9 / len(proofs)}}

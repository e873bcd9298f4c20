"""What the host did over a stretch of a run, read from the run's own process
and ``/proc`` (nothing is set): the process's and its main thread's CPU time
against the wall clock, the time its threads waited for a core, the machine's
stolen time and the involuntary context switches. A main thread whose CPU time
keeps up with the wall clock, with no wait, was slowed by its core, not kept
from it.
"""

from __future__ import annotations

import glob
import os
import resource
import time

_TICK = os.sysconf("SC_CLK_TCK")


def _run_delay_s() -> float:
    """Seconds the process's threads have waited on a run queue."""
    total = 0
    for path in glob.glob("/proc/self/task/*/schedstat"):
        try:
            with open(path) as f:
                total += int(f.read().split()[1])
        except (OSError, IndexError, ValueError):
            pass
    return total / 1e9


def _steal_s() -> float:
    """Seconds the hypervisor gave the machine's cores to others."""
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
        return int(fields[8]) / _TICK
    except (OSError, IndexError, ValueError):
        return float("nan")


def snapshot() -> dict:
    usage = resource.getrusage(resource.RUSAGE_SELF)
    return {"wall_s": time.time(), "cpu_s": usage.ru_utime + usage.ru_stime,
            "main_cpu_s": time.thread_time(), "wait_s": _run_delay_s(), "steal_s": _steal_s(),
            "switches": usage.ru_nivcsw}


def describe(before: dict, after: dict) -> str:
    d = {k: after[k] - before[k] for k in before}
    return (f"host over {d['wall_s']:.3f} s: process cpu {d['cpu_s']:.3f} s, main thread "
            f"{d['main_cpu_s']:.3f} s, run-queue wait {d['wait_s']:.3f} s, machine steal "
            f"{d['steal_s']:.2f} s, involuntary switches {d['switches']}")

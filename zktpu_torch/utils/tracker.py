"""Field-operation counting, parity with the reference's ``field-tracker``.

The reference wraps its field type in ``Ft!`` and dumps add/mul/inversion
counts inside tests via ``print_summary!()`` (SURVEY.md section 2, item 15;
sum_check/src/sum_check_protocol.rs:191,203 of the reference). Device
kernels can't count per-element at runtime, but every public field op knows
its batch size at dispatch time, so the wrappers in ``zktpu_torch.field.torch_backend``
report exact element counts here when tracking is enabled.

Usage:
    from zktpu_torch.utils import tracker
    tracker.enable()
    ... run a protocol ...
    tracker.print_summary()
"""

from __future__ import annotations

import collections
from contextlib import contextmanager

counters: collections.Counter = collections.Counter()
enabled = False


def enable() -> None:
    global enabled
    enabled = True


def disable() -> None:
    global enabled
    enabled = False


def reset() -> None:
    counters.clear()


def count(op: str, n: int) -> None:
    if enabled:
        counters[op] += int(n)


@contextmanager
def tracking():
    global enabled
    prev = enabled
    enabled = True
    try:
        yield counters
    finally:
        enabled = prev


def summary() -> dict:
    return dict(counters)


def print_summary() -> None:
    total = sum(counters.values())
    print("=== field-op summary ===")
    for op in sorted(counters):
        print(f"  {op:12s} {counters[op]:>14,d}")
    print(f"  {'total':12s} {total:>14,d}")

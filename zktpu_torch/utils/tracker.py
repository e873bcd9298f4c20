"""The port's one recorder: field-operation counts, and spans and work records
on the host clock.

Field-operation counting keeps parity with the reference's ``field-tracker``.
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

Spans and work records (``record(True)``; off by default):

  * ``span(name)``: what the host was doing, ``(name, start_ns, end_ns,
    depth)``, depth 0 for a span that no other encloses. A span never
    synchronises: the device's own trace says what the card was doing;
  * ``work(name, nbytes, ops, floor_ns)``: the least work of a launch or a
    phase, priced by ``utils.roofline`` (bytes moved, 32-bit multiply-adds,
    and the one-thread chain no other lane can share);
  * ``fetch(site, nbytes)``: a read from the device to the host, which waits
    for the queue to drain.

Times are ``time.time_ns()``, the clock that a device trace is moved onto
(``zkbench/harness/devtrace.py``), so spans and the card's idle gaps line up
with no further offset. With recording off a call site costs one check of
``recording``: call sites that price their work test it first.
"""

from __future__ import annotations

import collections
import time
from contextlib import contextmanager, nullcontext

counters: collections.Counter = collections.Counter()
enabled = False

#: whether spans, work records and fetches are recorded
recording = False
_spans: list = []  # (name, start_ns, end_ns, depth)
_work: list = []  # (time_ns, name, nbytes, ops, floor_ns)
_fetches: list = []  # (time_ns, site, nbytes)
_depth = 0
_OFF = nullcontext()


def enable() -> None:
    global enabled
    enabled = True


def disable() -> None:
    global enabled
    enabled = False


def reset() -> None:
    """Clear the field-op counters and the spans, work records and fetches."""
    counters.clear()
    _spans.clear()
    _work.clear()
    _fetches.clear()


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


# ----------------------------------------------------------------------
# spans, work records, fetches
# ----------------------------------------------------------------------

def record(on: bool) -> None:
    global recording
    recording = bool(on)


def span(name: str):
    """``with span(name): ...`` records the block's host time."""
    if not recording:
        return _OFF
    return _span(name)


@contextmanager
def _span(name: str):
    global _depth
    depth = _depth
    _depth = depth + 1
    start = time.time_ns()
    try:
        yield
    finally:
        _depth = depth
        _spans.append((name, start, time.time_ns(), depth))


def work(name: str, nbytes: int, ops: int, floor_ns: float = 0) -> None:
    if recording:
        _work.append((time.time_ns(), name, int(nbytes), int(ops), floor_ns))


def fetch(site: str, nbytes: int) -> None:
    if recording:
        _fetches.append((time.time_ns(), site, int(nbytes)))


def records() -> dict:
    """Copies of what was recorded: ``spans`` in the order they closed,
    ``work`` and ``fetches`` in the order they were made."""
    return {"spans": list(_spans), "work": list(_work), "fetches": list(_fetches)}

"""The program's own records in a traced run: the spans, work records and
device-to-host reads that ``zktpu_torch.utils.tracker`` keeps on the host
clock (``time.time_ns``), the clock the device trace is moved onto.

A reader of these records calls ``enable()`` when it is loaded; the runner
loads readers only in a traced run, before set-up, so an untimed run records
nothing. A program without the recorder gives ``None`` here and no error.
"""

from __future__ import annotations

from zktpu_torch.utils import tracker

from .peaks import PEAKS

#: the gaps of no program span
UNSTAGED = "no stage"


def enable() -> None:
    """Turn the program's recording on, where the program has it."""
    record = getattr(tracker, "record", None)
    if record is not None:
        record(True)


def source():
    """Everything the program recorded, or ``None`` without the recorder."""
    records = getattr(tracker, "records", None)
    return records() if records is not None else None


def window(reading):
    """The program's records inside the reading's window (the warm-up's left
    out): ``spans`` (name, start, end, depth) sorted by start, outer first;
    ``work`` (time, name, bytes, ops, floor ns); ``fetches`` (time, site,
    bytes). ``None`` where the program keeps no records."""
    found = source()
    if found is None:
        return None
    lo, hi = reading.window_ns
    return {
        "spans": sorted((s for s in found["spans"] if lo <= s[1] and s[2] <= hi),
                        key=lambda s: (s[1], s[3])),
        "work": [w for w in found["work"] if lo <= w[0] <= hi],
        "fetches": [f for f in found["fetches"] if lo <= f[0] <= hi],
    }


def idle_gaps(reading) -> list:
    """The intervals of the window in which no device record runs."""
    lo, hi = reading.window_ns
    gaps, cursor = [], lo
    for s, e in sorted((s, s + d) for _, s, d in reading.events):
        if s > cursor:
            gaps.append((cursor, min(s, hi)))
        cursor = max(cursor, e)
        if cursor >= hi:
            break
    if hi > cursor:
        gaps.append((cursor, hi))
    return [(a, b) for a, b in gaps if b > a]


def stage_timeline(spans) -> list:
    """(from_ns, innermost span open there, or ``UNSTAGED``), in time order,
    from properly nested spans."""
    edges = []
    for name, start, end, depth in spans:
        edges.append((start, 1, depth, name))
        edges.append((end, 0, -depth, name))
    edges.sort()
    timeline, stack = [], []
    for t, opens, _, name in edges:
        if opens:
            stack.append(name)
        elif stack:
            stack.pop()
        timeline.append((t, stack[-1] if stack else UNSTAGED))
    return timeline


def idle_by_stage(reading) -> dict:
    """The device's idle nanoseconds in the window, summed by the innermost
    program span open during each part of each gap (``UNSTAGED`` where none
    is); ``None`` where the program recorded no span in the window."""
    records = window(reading)
    if not (records and records["spans"]):
        return None
    timeline = stage_timeline(records["spans"])
    out: dict[str, int] = {}
    i, label = 0, UNSTAGED
    for a, b in idle_gaps(reading):
        while i < len(timeline) and timeline[i][0] <= a:
            label = timeline[i][1]
            i += 1
        t, j, cur = a, i, label
        while t < b:
            nxt = timeline[j][0] if j < len(timeline) else b
            end = min(nxt, b)
            out[cur] = out.get(cur, 0) + (end - t)
            if j < len(timeline) and nxt <= b:
                cur = timeline[j][1]
                j += 1
            t = end
    return out


def least_ns(records, peaks) -> float:
    """The least time of ``work`` records: each one's larger of bytes over the
    memory rate and operations over the integer rate, plus its floor."""
    return sum(max(nbytes / peaks["bytes_per_s"], ops / peaks["int32_mad_per_s"]) * 1e9 + floor
               for _, _, nbytes, ops, floor in records)


def kernel_share(reading, kernels, work):
    """100 x the least time of the window's ``work`` records (names) over the
    device time of its records whose names ``kernels`` (a compiled pattern)
    finds; ``None`` where the profile is unresolved, the card has no peaks or
    either side is empty."""
    peaks = PEAKS.get(reading.device_name)
    if not (peaks and reading.resolved and reading.events):
        return None
    records = window(reading)
    if not records:
        return None
    mine = [w for w in records["work"] if w[1] in work]
    lo, hi = reading.window_ns
    device_ns = sum(d for name, s, d in reading.events if lo <= s <= hi and kernels.search(name))
    if not (mine and device_ns):
        return None
    return 100.0 * least_ns(mine, peaks) / device_ns

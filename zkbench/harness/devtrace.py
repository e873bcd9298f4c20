"""The device trace of a traced run, and what the per-layer readers read.

The profiler (``torch.profiler``, device activity only) opens ``PAD_S`` before
the window and closes ``PAD_S`` after it, so that no record near an edge falls
outside its own window. Its records are read raw (``kineto_results``), not
through ``key_averages``, which takes minutes over a window's hundreds of
thousands of kernels.

The tracer's clock is not the host's: late in a process it has run ahead of
``time.time_ns`` by some milliseconds. So right after a ``synchronize`` at the
window's open and at its close the run launches a marker kernel
(``torch.cuda._sleep``, PyTorch's ``spin_kernel``) and notes the host clock;
each marker's record gives the offset there, and every record is moved onto
the host clock by the offset interpolated between the two, before it is
matched with the host's spans.

The program's kernel modules count their launches (``launches``, by kernel
name). A profile that holds fewer records of a kernel than its module counted
over the window has lost records: it is ``resolved = False``, and a reader of
device numbers then returns nothing.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import re
import sys
import time

#: seconds the profiler stays open before and after the window
PAD_S = 0.5
#: records whose names start so are copies and fills, not kernels
_NOT_KERNELS = ("Memcpy", "Memset")
#: the marker kernel's name, and its length in cycles
MARK = "spin_kernel"
MARK_CYCLES = 1000


def kernel_modules() -> list:
    """The program's imported modules that count their kernels' launches."""
    return [m for name, m in sorted(sys.modules.items())
            if name.split(".")[0] == "zktpu_torch" and m is not None
            and isinstance(getattr(m, "launches", None), dict)
            and isinstance(getattr(m, "KERNEL_NAMES", None), tuple)]


def launch_counts() -> dict[str, int]:
    counts: dict[str, int] = {}
    for module in kernel_modules():
        for name in module.KERNEL_NAMES:
            counts[name] = counts.get(name, 0) + int(module.launches.get(name, 0))
    return counts


@dataclasses.dataclass
class Reading:
    """What a per-layer reader reads about one traced window."""

    units: int  # work items completed in the window: proofs, transforms
    window_ns: tuple[int, int]
    spans: dict  # span name -> [(start_ns, end_ns)]
    events: list  # device records: (name, start_ns, duration_ns)
    resolved: bool  # profiled on a card, with a record of every launch counted
    launches: dict  # kernel name -> launches counted over the window
    config: dict
    mix: dict
    device_name: str

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    def span_ms(self, *names: str) -> float:
        return sum(end - start for n in names for start, end in self.spans.get(n, ())) / 1e6

    def kernels(self) -> list:
        return [e for e in self.events if not e[0].startswith(_NOT_KERNELS)]

    def busy_ns(self, events=None) -> int:
        """Length of the union of the records' intervals."""
        spans = sorted((s, s + d) for _, s, d in (self.events if events is None else events))
        total, cur_s, cur_e = 0, None, None
        for s, e in spans:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total

    def inside(self, names, events=None) -> list:
        """The records that start inside a span of one of ``names`` (spans of
        these names do not overlap)."""
        intervals = sorted(iv for n in names for iv in self.spans.get(n, ()))
        starts = [s for s, _ in intervals]
        out = []
        for e in (self.events if events is None else events):
            i = bisect.bisect_right(starts, e[1]) - 1
            if i >= 0 and e[1] <= intervals[i][1]:
                out.append(e)
        return out


def idle_pct(reading: Reading):
    """The share of the window in which no device record (kernel, copy or fill)
    runs, in percent; ``None`` where the profile is unresolved."""
    if not (reading.resolved and reading.events):
        return None
    return 100.0 * (1.0 - reading.busy_ns() / (reading.window_ns[1] - reading.window_ns[0]))


def to_host_clock(events: list, marks: list[int]):
    """``events`` without the markers, each moved onto the host clock, and the
    offsets (trace clock less host clock, ns) at the two markers; ``(events,
    None)`` where the profile does not hold exactly the two markers."""
    found = sorted(e[1] for e in events if MARK in e[0])
    rest = [e for e in events if MARK not in e[0]]
    if len(found) != 2 or len(marks) != 2:
        return rest, None
    offsets = [t - h for t, h in zip(found, marks)]
    slope = (offsets[1] - offsets[0]) / max(found[1] - found[0], 1)

    def offset(t):
        return offsets[0] + round(slope * (t - found[0]))

    return [(name, start - offset(start), d) for name, start, d in rest], offsets


def resolved(events: list, launches: dict) -> bool:
    """Whether the profile holds a record of each kernel launch counted. A
    kernel ``k`` is the records named ``k_kernel``; where none is, the records
    of each kernel named ``k_<part>_kernel`` (a launch may run several)."""
    names: dict[str, int] = {}
    for name, _, _ in events:
        names[name] = names.get(name, 0) + 1
    for kernel, count in launches.items():
        if count <= 0:
            continue
        exact = re.compile(rf"\b{kernel}_kernel\b")
        seen = sum(n for name, n in names.items() if exact.search(name))
        if seen == 0:
            part = re.compile(rf"\b{kernel}_\w+_kernel\b")
            parts = [n for name, n in names.items() if part.search(name)]
            seen = min(parts) if parts else 0
        if seen < count:
            return False
    return True


def _mark() -> int:
    """The host clock at the launch of a marker kernel on an idle card."""
    import torch

    torch.cuda.synchronize()
    host = time.time_ns()
    torch.cuda._sleep(MARK_CYCLES)
    torch.cuda.synchronize()
    return host


@contextlib.contextmanager
def device_profile(enabled: bool, out: list, marks: list):
    """Profile the card's activity around the block; its records go to
    ``out`` (on the tracer's clock), the host clock at the two markers to
    ``marks``."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PAD_S)
        marks.append(_mark())
        yield
        marks.append(_mark())
        time.sleep(PAD_S)
    for e in prof.profiler.kineto_results.events():
        if e.device_type().name == "CUDA":
            out.append((e.name(), e.start_ns(), e.duration_ns()))


def breakdown(reading: Reading, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps of the
    window summed by the span the host was in (``host outside spans``)."""
    by_name: dict[str, int] = {}
    for name, _, d in reading.events:
        by_name[name] = by_name.get(name, 0) + d
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    intervals = sorted((s, s + d) for _, s, d in reading.events)
    gaps, cursor = [], reading.window_ns[0]
    for s, e in intervals:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if reading.window_ns[1] > cursor:
        gaps.append((cursor, reading.window_ns[1]))
    spans = sorted((s, t, n) for n, ivs in reading.spans.items() for s, t in ivs)
    starts = [s for s, _, _ in spans]
    idle: dict[str, int] = {}
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        i = bisect.bisect_right(starts, mid) - 1
        inside = i >= 0 and mid <= spans[i][1]
        label = f"host in {spans[i][2]}" if inside else "host outside spans"
        idle[label] = idle.get(label, 0) + (g1 - g0)
    gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[name[:160], ns / 1e9] for name, ns in ops],
            "idle_gaps": [[label, ns / 1e9] for label, ns in gaps_top]}

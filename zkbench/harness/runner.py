"""One run of one cell: set-up, the window, the reading of the trace, the
check, and the result line.

``run`` works on any device, so that the tests can drive a whole run on the
CPU at a small size; ``run.py`` alone insists on a card.
"""

from __future__ import annotations

import time

import torch

from . import catalog, devtrace, hoststats
from .spans import Spans

#: top-level module names that may not be loaded in a run
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "zktpu")


def forbidden_loaded(modules) -> list[str]:
    """The forbidden top-level names among ``modules`` (names compared whole:
    ``zktpu_torch`` is not ``zktpu``)."""
    return sorted({name.split(".")[0] for name in modules} & set(FORBIDDEN_MODULES))


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def run(cell: catalog.Cell, seed: int, seconds: float, trace: bool, device, started: float,
        log=print) -> dict:
    """The result of one run, as the line ``run.py`` prints. ``started`` is the
    host clock (``time.time``) at the process's start: set-up is counted from
    it."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    readers = {m["name"]: catalog.metric_reader(m["name"]) for m in cell.per_layer} if trace else {}
    spans = Spans(sync=on_card)
    if trace:
        targets = {}
        for reader in readers.values():
            targets.update(getattr(reader, "SPANS", {}))
        for name, target in sorted(targets.items()):
            spans.install(name, target)

    traffic = catalog.generator(cell.mix["generator"]).Generator(cell.config, cell.mix, seed, device)
    imported = time.time()
    if on_card:
        torch.empty(1, device=device)  # the card's context
    context = time.time()
    traffic.setup()
    setup_peak = 0
    if on_card:
        torch.cuda.synchronize(device)
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.time() - started
    log(f"set-up {setup_s:.3f} s: start to set-up {imported - started:.3f} s, "
        f"card context {context - imported:.3f} s, "
        + ", ".join(f"{name} {sec:.3f} s" for name, sec in getattr(traffic, "setup_stages", [])))

    for records in spans.records.values():
        records.clear()  # the warm-up's
    events: list = []
    marks: list = []
    before = devtrace.launch_counts()
    host_before = hoststats.snapshot()
    with devtrace.device_profile(trace and on_card, events, marks):
        window = traffic.window(seconds)
    host_after = hoststats.snapshot()
    spans.uninstall()
    after = devtrace.launch_counts()
    events, offsets = devtrace.to_host_clock(events, marks)
    launches = {k: after[k] - before.get(k, 0) for k in after}
    window_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    log(f"window {(window['end_ns'] - window['start_ns']) / 1e9:.3f} s, "
        f"{window['units']} completed")
    log(hoststats.describe(host_before, host_after))
    for key in ("durations_s", "main_cpu_s"):
        if key in window:
            log(f"each, {key}: " + " ".join(f"{d:.4f}" for d in window[key]))

    values = {"setup_s": setup_s, "peak_device_gb": window_peak / 1e9, **window["metrics"]}
    result = {"correct": None, "attempted": window["attempted"], "failed": 0}
    if trace:
        reading = devtrace.Reading(
            units=window["units"], window_ns=(window["start_ns"], window["end_ns"]),
            spans=dict(spans.records), events=events,
            resolved=on_card and offsets is not None and devtrace.resolved(events, launches),
            launches=launches, config=cell.config, mix=cell.mix, device_name=_device_name(device))
        if on_card:
            log(f"trace clock less host clock at the window's open and close: {offsets} ns")
        if on_card and not reading.resolved:
            log(f"the profile lost records or markers: launches counted {launches}; "
                "device numbers unresolved")
        metrics = {}
        for m in cell.per_layer:
            value = readers[m["name"]].read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    result["metrics"] = metrics
    result["device"] = {"platform": "gpu" if on_card else "cpu", "kind": _device_name(device),
                        "count": cell.chips, "memory_peak_bytes": max(setup_peak, window_peak)}
    if trace:
        result["device"]["busy_s"] = reading.busy_ns() / 1e9
        result["device"]["window_s"] = reading.window_s
        result["breakdown"] = devtrace.breakdown(reading)
        result["trace_clock_offset_ns"] = offsets

    traffic.release()
    t0 = time.time()
    check = traffic.check()
    log(f"check of {check['checked']} against the reference: {time.time() - t0:.3f} s")
    result["failed"] = check["failed"]
    result["correct"] = all(value <= limit for _, value, limit in check["numbers"])
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in check["numbers"]}
    return result

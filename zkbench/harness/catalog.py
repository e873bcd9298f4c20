"""Finds what a cell is made of by the names in ``BENCHMARK.json``.

* a configuration: the JSON file its ``configs`` entry names;
* a traffic mix: ``mixes/<traffic>.json``, whose ``generator`` key names a
  module of ``zkbench/generators``;
* a per-layer metric: ``metrics/<name>.py``, which defines ``LAYER``,
  ``MOVES``, optionally ``SPANS`` (span name -> ``"module:attribute.path"``)
  and ``read(reading)``, returning a number or ``None`` where it found nothing
  to read.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _applies(metric: dict, cell_name: str, e2e_names) -> bool:
    """A metric with ``workloads`` applies to those cells; an end-to-end one
    without it to every cell; a per-layer one without it to every cell that
    reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def load_json(root: str, relative: str) -> dict:
    with open(os.path.join(root, relative)) as f:
        return json.load(f)


def mix_path(traffic: str) -> str:
    return os.path.join("zkbench", "mixes", traffic + ".json")


def find_cell(bench: dict, name: str, root: str = ROOT) -> Cell:
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (it has {sorted(cells)})")
    work = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root, configs[work["config"]]["file"])
    mix = load_json(root, mix_path(work["traffic"]))
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, ())]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _applies(m, name, e2e_names)]
    return Cell(name, int(work["chips"]), config, mix, e2e, layer)


def metric_reader(name: str, root: str = ROOT):
    """The module of ``metrics/<name>.py`` (a name may hold dots, so it is
    loaded by its path)."""
    path = os.path.join(root, "zkbench", "metrics", name + ".py")
    module_name = "zkbench_metric_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def generator(name: str):
    return importlib.import_module("zkbench.generators." + name)

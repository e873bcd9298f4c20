"""BENCHMARK.json keeps to the rules of its format as far as a file can show,
and every configuration, mix and metric it names is found by name and parses."""

import json
import os
import re

import pytest

from zkbench.harness import catalog

ROOT = catalog.ROOT
BENCH = catalog.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_keys_and_names():
    assert set(BENCH) == KEYS["top"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[section]]
        assert len(names) == len(set(names)), section
        for entry in BENCH[section]:
            extra = set(entry) - KEYS[section]
            assert extra <= ({"workloads"} if section in ("end_to_end", "per_layer") else set())
            assert NAME.match(entry["name"]), entry["name"]
            if "unit" in entry:
                assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in BENCH["end_to_end"])
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_command_and_paths_stay_inside():
    for path in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", path) and ".." not in path.split("/")
        assert not path.startswith("/") and os.path.isdir(os.path.join(ROOT, path))
    for word in BENCH["command"][1:]:
        assert any(word == p or word.startswith(p + "/") for p in BENCH["paths"])


def test_every_config_mix_and_metric_is_found_and_parses():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        config = catalog.load_json(ROOT, c["file"])
        assert config["name"] == c["name"] and config["reduced"] == c["reduced"] == []
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        cell = catalog.find_cell(BENCH, w["name"])
        assert catalog.generator(cell.mix["generator"]).Generator
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in names
    for m in BENCH["per_layer"]:
        reader = catalog.metric_reader(m["name"])
        assert reader.LAYER == m["layer"] and reader.MOVES == m["moves"] and callable(reader.read)
        assert m["moves"] in e2e
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("traffic", sorted({w["traffic"] for w in BENCH["workloads"]}))
def test_mix_files_parse(traffic):
    with open(os.path.join(ROOT, catalog.mix_path(traffic))) as f:
        mix = json.load(f)
    assert os.path.exists(os.path.join(ROOT, "zkbench", "generators", mix["generator"] + ".py"))

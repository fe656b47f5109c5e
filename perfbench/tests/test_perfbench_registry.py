"""BENCHMARK.json against the benchmark's files: every configuration,
traffic mix, scene, reference and metric is found by name, and the
entries keep to the contract's shapes."""

import importlib
import json
import re
from pathlib import Path

import pytest

from perfbench import harness

ROOT = Path(__file__).resolve().parent.parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys():
    assert set(BENCH) == KEYS
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_is_found_by_name(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"]) and cfg["reduced"] == []
    assert cfg["file"] == f"perfbench/configs/{cfg['name']}.json"
    config = harness.load_json(ROOT / cfg["file"])
    assert config["source"] == cfg["source"]
    assert harness.reference_module(config).FLOW_SIGN in (1.0, -1.0)
    assert config["solver"]["method"]


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_is_found_by_name(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and cell["chips"] == 1
    assert 1 <= len(cell["why"]) <= 200
    _b, _c, config, traffic = harness.cell_spec(cell["name"], ROOT)
    importlib.import_module(f"perfbench.scenes.{traffic['scene']}")
    e2e = harness.cell_metrics(BENCH, cell["name"], False)
    layers = harness.cell_metrics(BENCH, cell["name"], True)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert layers


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_has_a_reader(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert callable(harness.metric_reader(metric["name"]).read)
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        moves = {m["name"] for m in BENCH["end_to_end"]}
        assert metric["moves"] in moves and metric["layer"]
    if metric["name"].endswith("_roofline"):
        assert metric["unit"] == "%"


def test_pairs_and_names_are_unique():
    pairs = [(c["config"], c["traffic"]) for c in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names)

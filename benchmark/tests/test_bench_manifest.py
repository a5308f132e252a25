"""BENCHMARK.json keeps to the benchmark's contract, and every cell finds its
configuration, traffic mix, driver, limits and metric readers by name."""

import importlib
import json
import os
import re

import pytest

from benchmark import run
from benchmark.tests.tiny import HERE, ROOT, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [c["name"] for c in manifest()["workloads"]]


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert m["command"][:3] == ["python3", "-m", "benchmark.run"] and len(m["command"]) <= 32
    assert m["paths"] == ["benchmark"]
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    assert len(json.dumps(m)) <= 64 * 1024


def test_full_check_fits_with_24_cells():
    rs = manifest()["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs():
    for c in manifest()["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["why"]) and _line(c["source"])
        assert c["source"].startswith("https://")
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        body = json.load(open(os.path.join(ROOT, c["file"])))
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"] == []
        assert body["compute_dtype"] == "bfloat16"


def test_metrics():
    m = manifest()
    e2e = {x["name"]: x for x in m["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for x in m["end_to_end"]:
        assert set(x) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert x["source"] in ("host_clock", "device_trace")
        assert 0.01 <= x["bound"] <= 0.25
    for x in m["end_to_end"] + m["per_layer"]:
        assert NAME.match(x["name"]) and UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
    names = [x["name"] for x in m["end_to_end"] + m["per_layer"]]
    assert len(names) == len(set(names))
    for x in m["per_layer"]:
        assert set(x) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert x["moves"] in e2e and _line(x["layer"])
        assert x["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for w in x["workloads"]:
            assert w in CELLS and w in e2e[x["moves"]].get("workloads", CELLS)


@pytest.mark.parametrize("workload", CELLS)
def test_cell_resolves_by_name(workload):
    m = manifest()
    cell = next(c for c in m["workloads"] if c["name"] == workload)
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1 and _line(cell["why"]) and NAME.match(cell["traffic"])
    assert cell["config"] in {c["name"] for c in m["configs"]}
    traffic = run.load_json(HERE, "traffic", f"{cell['traffic']}.json")
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    assert callable(driver.run)
    limits = run.load_json(HERE, "limits", f"{workload}.json")
    assert limits and all(v >= 0 for v in limits.values())
    e2e = run.cell_metrics(m, cell, trace=False)
    assert "setup_s" in {x["name"] for x in e2e} and len(e2e) >= 2
    per_layer = run.cell_metrics(m, cell, trace=True)
    assert per_layer
    for x in per_layer:
        assert callable(run.load_reader(x["name"]))
        assert run.load_reader(x["name"])(None) is None


def test_pairs_of_config_and_traffic_are_unique():
    pairs = [(c["config"], c["traffic"]) for c in manifest()["workloads"]]
    assert len(pairs) == len(set(pairs))

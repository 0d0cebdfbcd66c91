"""BENCHMARK.json against the contract's shape, and every cell's files
found and resolved by name."""

import json
import os
import re

import pytest

from benchmark import harness

BENCH = harness.load_json(harness.ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) \
        < 64 * 1024


def test_names_units_and_bounds():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_configs_are_used_and_found():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("benchmark/")
        cfg = json.load(open(os.path.join(harness.ROOT, c["file"])))
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = harness.load_cell(name)
    assert cell.chips == 1
    drv = harness.driver(cell.workload["engine"])
    for fn in ("measure", "check"):
        assert callable(getattr(drv, fn))
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(harness.reader(m["name"]).read)
        assert BENCH_MOVES_REPORTED(m, cell)
    assert cell.workload["limits"]


def BENCH_MOVES_REPORTED(metric, cell):
    return metric["moves"] in {m["name"] for m in cell.end_to_end}


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        harness.load_cell("no_such.cell")

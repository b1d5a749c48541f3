"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""
import json
import re

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BENCH = harness.benchmark_spec()


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    # a full check of 24 cells fits: 2 + 14 n runs of run_seconds + 60, 2 x 90 a cell, 1200 spare
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_keys():
    names = [c["name"] for c in BENCH["configs"]]
    cells = [w["name"] for w in BENCH["workloads"]]
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    for group in (names, cells, metrics):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(cells)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES
        assert m["moves"] in [e["name"] for e in BENCH["end_to_end"]]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert all(c in cells for c in m.get("workloads", []))
    assert "setup_s" in metrics


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for cell in (w["name"] for w in BENCH["workloads"]):
        e2e = {m["name"] for m in harness.end_to_end_of(BENCH, cell)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = harness.per_layer_of(BENCH, cell)
        assert layers and all(m["moves"] in e2e for m in layers)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    entry = harness.cell_entry(BENCH, cell)
    workload = harness.workload_file(cell)
    assert workload["config"] == entry["config"]
    assert set(workload) == {"config", "driver", "traffic", "limits"}
    driver = __import__(f"portbench.drivers.{workload['driver']}", fromlist=["run"])
    assert callable(driver.run) and callable(driver.check)
    config = harness.config_file(entry["config"])
    assert config["name"] == entry["config"] and config["reduced"] == []
    assert all(limit > 0 for limit in workload["limits"].values())


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_readers_found_by_name(metric):
    reader = harness.load_metric(metric)
    assert callable(reader.read)
    for path in getattr(reader, "COUNTERS", {}).values():
        assert isinstance(harness._read_counter(path), int)


def test_config_files_match_their_entries():
    for c in BENCH["configs"]:
        config = harness.config_file(c["name"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert config["source"] == c["source"] and config["reduced"] == c["reduced"]
        assert config["assumed"]

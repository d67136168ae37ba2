"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""

import json
import re

import pytest

from benchmark import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return spec.load()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert len(json.dumps(bench)) <= 64 * 1024


def test_names_units_and_lines(bench):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group if group in ("configs", "workloads") else "metric",
                          entry["name"]))
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]
                    assert "\t" not in entry[key]
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    assert len(names) == len(set(names))


def test_every_cell_finds_its_files(bench):
    for cell in bench["workloads"]:
        assert cell["chips"] in (1, 4)
        cfg = spec.config(bench, cell["config"])
        assert cfg["rows"] > 0 and cfg["diffusion"]["max_iterations"] > 0
        traffic = spec.traffic(cell["traffic"])
        assert traffic["driver"] in ("session", "server")
        assert spec.limits(cell["name"])
        e2e = {m["name"] for m in spec.metrics_of(bench, cell["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        per_layer = spec.metrics_of(bench, cell["name"], "per_layer")
        assert per_layer and all(m["moves"] in e2e for m in per_layer)
        for m in per_layer:
            assert callable(spec.reader(m["name"]))
    used = {c["config"] for c in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}


def test_metric_entries(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["source"] in SOURCES and m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"

"""``BENCHMARK.json`` and the files it names, found by name.

A cell's configuration is ``configs/<config>.json``, its traffic mix
``traffic/<traffic>.json``, the limits of its comparison
``limits/<cell>.json``, and each per-layer metric's reader
``metrics/<metric>.py`` (a ``read(rec)`` that returns a number or None).
Adding a cell, a configuration, a mix or a metric adds files and entries;
no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SPEC = ROOT / "BENCHMARK.json"


def load(path=SPEC) -> dict:
    with open(path) as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                     f"(there are {[w['name'] for w in spec['workloads']]})")


def config(spec: dict, name: str) -> dict:
    """The configuration file of the config ``name``, as BENCHMARK.json
    points to it."""
    for c in spec["configs"]:
        if c["name"] == name:
            return _json(ROOT / c["file"])
    raise SystemExit(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str, base: Path = HERE) -> dict:
    return _json(base / "traffic" / f"{name}.json")


def limits(cell_name: str, base: Path = HERE) -> dict:
    return _json(base / "limits" / f"{cell_name}.json")


def reader(metric: str, base: Path = HERE):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = base / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def metrics_of(spec: dict, cell_name: str, kind: str) -> list:
    """The entries of ``spec[kind]`` ("end_to_end" or "per_layer") that the
    cell reports: those that list it under ``workloads``, and those with no
    such list that move an end-to-end metric the cell reports (every cell,
    for an end-to-end metric without a list)."""
    def listed(m, name):
        return "workloads" not in m or name in m["workloads"]

    e2e = [m for m in spec["end_to_end"] if listed(m, cell_name)]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in names)]

"""``BENCHMARK.json`` and the files it names, found by name.

A cell's configuration is ``configs/<config>.json``, its traffic mix
``traffic/<traffic>.json``, the limits of its comparison
``limits/<cell>.json``, each per-layer metric's reader
``metrics/<metric>.py`` (a ``read(rec)`` that returns a number or None),
and the reference a configuration is held to, ``reference/<config>.py``
where the configuration has one, else ``reference/plain.py`` (the
functions of ``plain.INTERFACE``). Adding a cell, a configuration, its
reference, a mix or a metric adds files and entries; no file here changes.
"""

from __future__ import annotations

import ast
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SPEC = ROOT / "BENCHMARK.json"
# Top-level module names, compared whole, that no run may load: JAX and the
# JAX package. A reference imports none of them, nor the port (``PORT``),
# whose results it judges.
FORBIDDEN = ("jax", "jaxlib", "flax", "realtimedepthdiffusion_tpu")
PORT = "realtimedepthdiffusion_tpu_torch"


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


def _module(name: str, path: Path):
    """The module in the file ``path``, loaded by path, so that a name with
    ``.`` or ``-`` in it works."""
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def reader(metric: str, base: Path = HERE):
    """The ``read`` function of ``metrics/<metric>.py``."""
    return _module(f"benchmark_metric_{metric}", base / "metrics" / f"{metric}.py").read


def _imports(path: Path) -> set:
    """The top-level names of the modules the file ``path`` imports, at its
    top or inside a function."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def reference(config_name: str, base: Path = HERE):
    """The reference module the configuration ``config_name`` is held to:
    ``reference/<config>.py`` where that file exists (it imports what it
    keeps from ``benchmark.reference.plain`` and defines what differs),
    else ``plain``. Refuses a file that imports JAX, the JAX package or the
    port (``FORBIDDEN``, ``PORT``), or whose loading brings one in, and a
    module that lacks a function of ``plain.INTERFACE``."""
    from .reference import plain

    path = base / "reference" / f"{config_name}.py"
    if not path.is_file():
        return plain
    refused = set(FORBIDDEN) | {PORT}
    named = _imports(path) & refused
    if named:
        raise SystemExit(f"the reference {path} imports {sorted(named)}")
    before = set(sys.modules)
    mod = _module(f"benchmark_reference_{config_name}", path)
    brought = sorted(m for m in set(sys.modules) - before if m.split(".")[0] in refused)
    if brought:
        raise SystemExit(f"loading the reference {path} brings in {brought}")
    missing = [f for f in plain.INTERFACE if not callable(getattr(mod, f, None))]
    if missing:
        raise SystemExit(f"the reference {path} lacks {missing} (plain.INTERFACE)")
    return mod


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

"""Small versions of the benchmark's cells for the CPU tests: 192 x 256
images (three pyramid levels), 64 iterations, a 64 px window; the cells'
own traffic, cut to fit."""

import copy
import time

from benchmark import harness, spec

ROWS, COLS = 192, 256
TRAFFIC_CUTS = {
    "strokes": {"margin": 4, "max_updates": 400},
    # A brush of 3 + 2 * 31 = 65 px passes the 64 px window.
    "spread": {"brush_steps": 31, "margin": 36, "max_updates": 400},
    "batch": {"pairs": 3, "chunk": 3, "warm_pairs": 1},
}
COMMON_CUTS = {"trace_updates": 3, "check_updates": 2}


def bench():
    return spec.load()


def config(cell):
    c = copy.deepcopy(spec.config(bench(), cell["config"]))
    c["rows"], c["cols"] = ROWS, COLS
    c["diffusion"].update(max_iterations=64, incremental_window=64)
    return c


def traffic(cell):
    t = dict(spec.traffic(cell["traffic"]))
    t.update(TRAFFIC_CUTS[cell["traffic"]])
    if t["driver"] == "session":
        t.update(COMMON_CUTS)
    return t


def run(cell_name, seed=2**33 + 7, seconds=0.5, traced=False, bench_spec=None, **kw):
    """``harness.run_cell`` of the small cell on the CPU."""
    b = bench_spec or bench()
    cell = spec.cell(b, cell_name)
    kw.setdefault("cfg", config(cell))
    kw.setdefault("traffic", traffic(cell))
    return harness.run_cell(b, cell, seed, seconds, traced, "cpu", time.perf_counter(), **kw)

#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 --seconds 3

For each seed, in one process: the cell's set-up and a short window as a
run makes them, then the comparison's numbers: the program's (the lower
readings) and, on the first ``--control-seeds`` seeds, the control's, the
configuration's reference (``spec.reference``) computed in bfloat16 put in
the program's place (the upper readings). One JSON line per
seed and side on stdout. Needs the cell's CUDA device; the benchmark's own
runs never run this.
"""

import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[0] = os.path.dirname(HERE)

from benchmark import env  # noqa: E402

env.prepare()

import argparse  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import tempfile  # noqa: E402


def readings(cell_name, seeds, seconds, device="cuda", cfg=None, traffic=None, n_control=None):
    """[(seed, "program" | "control", numbers, check seconds)] for
    ``cell_name``; the control on the first ``n_control`` seeds (all if
    None)."""
    import torch

    from benchmark import harness, spec

    bench = spec.load()
    cell = spec.cell(bench, cell_name)
    cfg = cfg or spec.config(bench, cell["config"])
    traffic = traffic or spec.traffic(cell["traffic"])
    reference = spec.reference(cell["config"])
    out = []
    for k, seed in enumerate(seeds):
        tmp = tempfile.mkdtemp(prefix="rtdd-control-")
        try:
            run = harness.DRIVERS[traffic["driver"]](cfg, traffic, seed, device, tmp, reference)
            run.setup()
            run.window(seconds)
            run.release()
            t0 = time.perf_counter()
            out.append((seed, "program", run.check(), time.perf_counter() - t0))
            if n_control is None or k < n_control:
                out.append((seed, "control", run.check(stand_in=torch.bfloat16), None))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return out


def main(argv):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control-seeds", type=int, default=None,
                   help="run the control on the first N seeds only")
    a = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    from realtimedepthdiffusion_tpu_torch.utils.cache import enable_compilation_cache

    enable_compilation_cache(os.path.join(env.CACHE, "kernels"))
    for seed, side, numbers, check_s in readings(
            a.workload, [int(s) for s in a.seeds.split(",")], a.seconds,
            n_control=a.control_seeds):
        print(json.dumps({"workload": a.workload, "seed": seed, "side": side,
                          "numbers": numbers, "check_s": check_s}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

#!/usr/bin/env python3
"""The benchmark of ``realtimedepthdiffusion_tpu_torch`` on NVIDIA GPUs:
one run of one cell of ``BENCHMARK.json``.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. It needs the cell's CUDA device(s) and
exits non-zero without a result where they are missing. The kernels' nvcc
build lands under ``benchmark/.cache/`` in the checkout, the native
runtime's g++ build in the package's own ``native/build/``. ``setup_s``
counts from the first line of this file.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# The checkout's root, not this directory, leads the import path.
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark import env  # noqa: E402

env.prepare()

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))

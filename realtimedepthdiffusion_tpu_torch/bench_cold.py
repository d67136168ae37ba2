"""Cold start of the port in a fresh process (twin of the repository's root
``bench_cold.py``): one JSON line on stdout.

    python -m realtimedepthdiffusion_tpu_torch.bench_cold [--device cuda]
    RTDD_NO_COMPILE_CACHE=1 python -m realtimedepthdiffusion_tpu_torch.bench_cold

At the headline's 1080p geometry and default config, it times from this
module's import (``T_PROC``; the package's ``__init__`` loads no torch):

- ``import_s``: torch and the port imported, and the card initialised;
- ``build_s``: the nvcc build of the kernels this process ran
  (``ops/build.py:build_seconds``), null when the library came from the
  build cache;
- ``load_s``: ``load_library()``'s wall time, the build included;
- ``first_solve_s``: annotation ready -> the first ``depth_u8`` on the
  host (the number a user feels at start-up);
- ``time_to_first_depth_s``: ``T_PROC`` -> that same readback.

- ``fused_switch_s``: ``T_PROC`` -> ``wait_fused`` returned, after the
  first solve, as the JAX script asks it (``bench_cold.py:69-97``:
  ``prewarm_async``, one solve, ``wait_fused``). After one fast-start
  solve nothing has been kicked (the second solve captures the graph), so
  it returns at once, as JAX's does.

``vs_baseline`` = 5 s / ``first_solve_s``. With
``RTDD_NO_COMPILE_CACHE=1`` the kernels build into a directory of this
process (``utils/cache.py``), so the same run times a cold nvcc build.
The input is the JAX script's: ``default_rng(0)``'s uniform RGB and the
headline's five scribble blocks (it never reads a dataset image).
"""

import time

T_PROC = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from typing import List, Optional  # noqa: E402

COLD_BUDGET_S = 5.0
# The JAX script's cap on wait_fused.
FUSED_WAIT_S = 300.0
NOTE = ("fast_start: the first solve runs eagerly and the second captures the CUDA graph "
        "of the solve, so after one solve wait_fused has nothing to wait for")


def cold_start(h: int = 1080, w: int = 1920, cfg=None, device="cuda",
               t_proc: float = T_PROC) -> dict:
    """Import torch and the port, initialise ``device``, load (or build) the
    kernels, and solve the JAX script's input once at (h, w) under ``cfg``
    (the default config with ``fast_start`` on if None, as the JAX script
    runs it), timing each from ``t_proc``; prints the record as one JSON
    line on stdout and returns it."""
    import numpy as np
    import torch

    from .bench import device_name, log, seeded_inputs, size_label
    from .config import DiffusionConfig
    from .ops import build
    from .pipeline import DepthPipeline
    from .serve import require_device

    dev = require_device(device)
    if dev.type == "cuda":
        torch.zeros(1, device=dev)
        torch.cuda.synchronize(dev)
    t_import = time.perf_counter() - t_proc
    log(f"import+device: {t_import:.2f}s; device: {dev} ({device_name(dev)})")
    load_s = None
    if dev.type == "cuda":
        t0 = time.perf_counter()
        build.load_library()
        load_s = time.perf_counter() - t0
        log(f"kernels: {load_s:.2f}s (nvcc {build.build_seconds} s) -> "
            f"{build.library_path()}")

    cfg = DiffusionConfig(fast_start=True) if cfg is None else cfg
    pipe = DepthPipeline(h, w, cfg, device=dev)
    pipe.prewarm_async()  # the session constructor's kick (live/session.py)
    rgb, mask, value = seeded_inputs(h, w)
    rgb_d, gpyr = pipe.prepare_image(rgb)

    t0 = time.perf_counter()
    depth, _state = pipe.solve(gpyr, torch.from_numpy(mask).to(dev),
                               torch.from_numpy(value).to(dev), pipe.initial_state())
    u8 = pipe.depth_u8(depth).cpu().numpy()  # the host readback completes the frame
    first_solve_s = time.perf_counter() - t0
    ttfd_s = time.perf_counter() - t_proc
    if u8.shape != (h, w) or not np.array_equal(u8[mask], value[mask]):
        raise RuntimeError("the first solve did not return the scribbled depth map")
    log(f"first solve: {first_solve_s:.3f}s; time-to-first-depth: {ttfd_s:.2f}s")
    fused_switch_s = None
    if pipe.wait_fused(timeout=FUSED_WAIT_S):
        fused_switch_s = time.perf_counter() - t_proc
        log(f"wait_fused returned at {fused_switch_s:.2f}s")

    kernels = ("plain torch versions, no kernels" if dev.type != "cuda"
               else "kernels loaded from the build cache" if build.build_seconds is None
               else "kernels built by nvcc in this process")
    first = round(first_solve_s, 3)
    record = {
        "metric": f"{size_label(h, w)} cold start: fresh-process time-to-first-depth "
                  f"(fast_start eager path on {device_name(dev)}, {kernels})",
        "value": round(ttfd_s, 3),
        "unit": "s",
        "vs_baseline": round(COLD_BUDGET_S / max(first, 1e-9), 3),
        "detail": {
            "import_s": round(t_import, 3),
            "build_s": None if build.build_seconds is None else round(build.build_seconds, 3),
            "load_s": None if load_s is None else round(load_s, 3),
            "first_solve_s": first,
            "time_to_first_depth_s": round(ttfd_s, 3),
            "fused_switch_s": None if fused_switch_s is None else round(fused_switch_s, 3),
            "note": NOTE,
            "contract": f"first solve < {COLD_BUDGET_S:g} s on {device_name(dev)}, after "
                        "the kernels' build or load (load_s)",
        },
    }
    print(json.dumps(record), flush=True)
    return record


def main(argv: Optional[List[str]] = None) -> int:
    from .serve import device_arg, require_device
    from .utils.cache import enable_compilation_cache

    p = argparse.ArgumentParser(prog="python -m realtimedepthdiffusion_tpu_torch.bench_cold",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", type=device_arg, default="cuda",
                   help="cuda (default), cuda:N or cpu; a card asked for where there is "
                        "none raises")
    a = p.parse_args(argv)
    require_device(a.device)
    enable_compilation_cache()
    cold_start(device=a.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

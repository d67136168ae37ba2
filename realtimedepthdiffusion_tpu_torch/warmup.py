"""rtdd-warmup-torch (port of ``realtimedepthdiffusion_tpu/warmup.py``): warm
the port for a set of image shapes before they are served.

The JAX tool compiles every product program into XLA's persistent cache.
Here the one thing that persists across processes is the nvcc build of the
kernels (``ops/build.py``, in the directory of ``utils/cache.py``: the
package's ``build/``, or ``RTDD_CACHE_DIR``). This tool builds it, asks the
card once what the routes need (the largest K2 cluster it runs and its L2
size), and then runs each path the JAX tool compiles once, on a seeded
image of each shape, printing its seconds under the JAX tool's names. Then
it captures, in this process, the programs the JAX tool lowers there: the
CUDA graph of ``solve`` and of ``solve+effect[e]`` for each effect
(``DepthPipeline.capture``), and with --incremental those of the windowed
re-solve (``capture_incremental``), printing each one's capture and
instantiation seconds. Graphs, like the runs, warm only the process that makes them
(CUDA's module load, the allocator's first blocks, the card queries):
another process gains the build alone, and a serving process that wants
its first pair warm calls ``warm_shape`` itself first.

    rtdd-warmup-torch --size 1080p --size 4k --effect b
    rtdd-warmup-torch --images dataset/images          # every distinct shape
    rtdd-warmup-torch --size 1080p --profile fast --incremental 120 --device cuda:1

Paths run per shape: solve, the gray pyramid, the u8/u16 depth readouts,
solve+effect and the effect for each --effect, and (with --incremental) the
windowed live re-solve with and without each effect; then the graphs. The fast-start path runs eagerly (the JAX
tool's staged programs). --jobs bounds the nvcc processes of the build.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional, Tuple

_ALIASES = {
    "1080p": (1080, 1920),
    "720p": (720, 1280),
    "1440p": (1440, 2560),
    "4k": (2160, 3840),
    "2160p": (2160, 3840),
}


def parse_size(s: str) -> Tuple[int, int]:
    """'1080p' / '4k' aliases or explicit 'HxW' (rows x cols)."""
    v = s.lower().strip()
    if v in _ALIASES:
        return _ALIASES[v]
    try:
        h, w = v.split("x", 1)
        return int(h), int(w)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"size {s!r}: expected HxW or one of {sorted(_ALIASES)}"
        )


def shapes_from_images(images_dir: str) -> List[Tuple[int, int]]:
    """Distinct image shapes in a directory, from headers only (no pixel
    decode) — warms exactly the shapes a serve run over it will need."""
    import os

    from .io import image_size

    shapes = []
    for f in sorted(os.listdir(images_dir)):
        if os.path.splitext(f)[1].lower() in (".png", ".jpg", ".jpeg"):
            try:
                s = image_size(os.path.join(images_dir, f))
            except Exception as e:
                print(f"warning: {f}: {e}", file=sys.stderr)
                continue
            if s not in shapes:
                shapes.append(s)
    return shapes


def warm_shape(
    rows: int,
    cols: int,
    cfg,
    effects: List[int],
    incremental: bool,
    jobs: int = 6,
    log=print,
    *,
    device="cuda",
) -> float:
    """Warm one shape on ``device``; returns wall seconds. On a card: build
    (or load) the kernels with at most ``jobs`` nvcc processes and ask the
    card for K2's largest cluster and its L2 size. Then run each path once
    on a seeded image of the shape, logging its seconds (to the end of its
    device work), and capture the programs the JAX tool compiles (the
    solve's, and with ``incremental`` the windowed re-solve's), logging
    their capture seconds (0 on the CPU, where nothing is captured)."""
    import numpy as np
    import torch

    from .ops import build, dispatch, sweep
    from .pipeline import DepthPipeline
    from .serve import require_device

    dev = require_device(device)
    t_shape = time.perf_counter()

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        log(f"  {rows}x{cols} {name}: {time.perf_counter() - t0:.3f} s")
        return out

    if dev.type == "cuda":
        timed("build", lambda: build.load_library(jobs))
    max_cluster, l2 = sweep.resident_max_cluster(dev), dispatch.l2_bytes(dev)
    log(f"  {rows}x{cols} card: K2 cluster up to {max_cluster}, L2 {l2} bytes, "
        f"route of L0 {sweep.strip_route(rows, cols, l2, max_cluster)}")

    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (rows, cols, 3), dtype=np.uint8)
    mask = np.zeros((rows, cols), bool)
    value = np.zeros((rows, cols), np.uint8)
    mask[rows // 4, cols // 4] = True
    value[rows // 4, cols // 4] = 254
    mask[3 * rows // 4, 3 * cols // 4] = True
    center = (rows // 2, cols // 2)

    pipe = DepthPipeline(rows, cols, cfg, device=dev)
    rgb_d, gp = timed("gray_pyramid", lambda: pipe.prepare_image(rgb))
    m0, v0 = torch.from_numpy(mask).to(dev), torch.from_numpy(value).to(dev)
    depth, state = timed("solve", lambda: pipe.solve(gp, m0, v0, pipe.initial_state()))
    timed("depth_u8", lambda: pipe.depth_u8(depth))
    timed("depth_u16", lambda: pipe.depth_u16(depth))
    clipped = torch.clamp(depth, 0.0, 255.0)
    for e in effects:
        timed(f"solve+effect[{e}]",
              lambda: pipe.solve_and_effect(e, gp, rgb_d, m0, v0, pipe.initial_state()))
        timed(f"effect[{e}]", lambda: pipe.effect(e, rgb_d, gp[0], clipped))
    if incremental:
        timed("incremental", lambda: pipe.solve_incremental(gp, m0, v0, state, center))
        for e in effects:
            timed(f"incremental+effect[{e}]",
                  lambda: pipe.solve_incremental_and_effect(e, gp, rgb_d, m0, v0, state, center))
    programs = [("solve", pipe.capture, None, (gp, m0, v0, state))]
    programs += [(f"solve+effect[{e}]", pipe.capture, e, (gp, rgb_d, m0, v0, state))
                 for e in effects]
    if incremental:
        programs.append(("incremental", pipe.capture_incremental, None,
                         (gp, m0, v0, state, center)))
        programs += [(f"incremental+effect[{e}]", pipe.capture_incremental, e,
                      (gp, rgb_d, m0, v0, state, center)) for e in effects]
    for name, capture, e, args in programs:
        log(f"  {rows}x{cols} {name} graph: {capture(e, *args):.3f} s")
    return time.perf_counter() - t_shape


def main(argv: Optional[List[str]] = None) -> int:
    from .serve import _EFFECT_BY_KEY, config_from_args, device_arg

    p = argparse.ArgumentParser(prog="rtdd-warmup-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--size", action="append", type=parse_size, default=[],
                   metavar="HxW|1080p|4k", help="shape to warm (repeatable)")
    p.add_argument("--images", help="warm every distinct shape in this "
                                    "directory (headers only)")
    p.add_argument("--effect", action="append", default=[],
                   choices=["b", "g", "h"],
                   help="also warm solve+effect and the effect (repeatable)")
    p.add_argument("--incremental", type=int, default=0, metavar="N",
                   help="also warm the windowed live re-solve (budget N)")
    p.add_argument("--jobs", type=int, default=6,
                   help="concurrent nvcc processes of the build (default 6)")
    p.add_argument("--device", type=device_arg, default="cuda",
                   help="cuda (default), cuda:N or cpu")
    # Solver-surface flags, resolved exactly like rtdd-serve's.
    p.add_argument("--backend", default="auto")
    p.add_argument("--profile", choices=["faithful", "fast"], default=None)
    p.add_argument("--solver", default=None,
                   choices=["jacobi_chebyshev", "jacobi", "red_black"])
    p.add_argument("--multigrid", choices=["cascadic", "vcycle"], default=None)
    p.add_argument("--iterations", type=int, default=None)
    p.add_argument("--early-exit", action="store_true")
    p.add_argument("--tolerance", type=float, default=None)
    p.add_argument("--residual-metric", default=None, choices=["rms", "max"])
    p.add_argument("--rb-rho", type=float, default=None)
    p.add_argument("--rb-plain", action="store_true")
    p.add_argument("--defocus-quality", choices=["auto", "exact", "approx"],
                   default=None)
    p.add_argument("--defocus-stride", type=int, default=None, metavar="N")
    a = p.parse_args(argv)

    shapes = list(a.size)
    if a.images:
        for s in shapes_from_images(a.images):
            if s not in shapes:
                shapes.append(s)
    if not shapes:
        print("no shapes to warm (pass --size and/or --images)",
              file=sys.stderr)
        return 2

    import dataclasses

    cfg = config_from_args(a, p.error)
    if a.incremental > 0:
        cfg = dataclasses.replace(
            cfg, incremental_iterations=max(int(a.incremental), 0)
        )

    from .utils.cache import enable_compilation_cache

    cache = enable_compilation_cache()
    print(f"build cache: {cache or 'DISABLED'}")
    effects = [_EFFECT_BY_KEY[e] for e in dict.fromkeys(a.effect)]
    t0 = time.perf_counter()
    for h, w in shapes:
        dt = warm_shape(h, w, cfg, effects, a.incremental > 0, a.jobs, device=a.device)
        print(f"{h}x{w}: warmed in {dt:.3f} s")
    print(f"total: {len(shapes)} shape(s) in {time.perf_counter() - t0:.3f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

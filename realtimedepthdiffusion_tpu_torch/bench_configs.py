"""The five BASELINE configurations on the card, one JSON line each (twin of
the repository's root ``bench_configs.py``, with its metric names):

1. Jacobi scribble diffusion, fixed iterations (a cascade step)
2. Red-black Gauss-Seidel with the residual early exit
3. Edge-aware anisotropic Laplacian weights from image gradients (L0)
4. The full multigrid V-cycle at 1080p
5. The live loop: the windowed incremental re-solve and the haze effect

    python -m realtimedepthdiffusion_tpu_torch.bench_configs [--device cuda]

Each number is ``bench.chained_ms``: (t(K) - t(1)) / (K - 1) over the min
of three envelopes, each chain ending in one host readback of a reduced
scalar, so it keeps what the host spends launching, as a user pays it.
The inputs are the headline bench's (``bench.bench_inputs``) at 1080p.

Config 2's early exit reads one residual back to the host per chunk of
``residual_check_every`` iterations (``core/solver.py:_chunked_early_exit``)
and so waits for the card there, inside the timed chain: that is the
port's design, and the count of those reads a frame is logged. Config 5
takes its centre as host integers, so it reads nothing back per frame, and
computes the effect each frame without tying it into the state (the JAX
bench does that only to keep XLA from dropping it).
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

from .bench import BUDGET_MS, bench_inputs, chained_ms, emit, log
from .config import DiffusionConfig
from .core import effects as fx
from .core.color import rgb_to_gray
from .core.incremental import solve_incremental
from .core.multigrid import build_gray_pyramid, initial_depth_state, solve_cascade, solve_vcycle
from .core.weights import edge_weights
from .serve import device_arg, require_device

NAMES = (
    "config1 jacobi cascade 1080p (fixed 1937 sweeps)",
    "config2 red-black GS + early exit 1080p",
    "config3 edge-aware Laplacian weights 1080p",
    "config4 full V-cycle 1080p (warm cascade + 2 cycles)",
    "config5 live incremental update (windowed) + fused haze 1080p",
)
CENTER = (140, 230)  # at the first scribble block


class Case(NamedTuple):
    name: str
    cfg: DiffusionConfig
    step: Callable  # state -> state, one frame
    state0: object  # a tuple of per-level planes, or config 3's one plane
    k: int


def config_cases(rgb, mask, value, device, over: Optional[dict] = None,
                 center: Tuple[int, int] = CENTER) -> List[Case]:
    """The five steps of bench_configs.py on the host arrays (rgb, mask,
    value), uploaded to ``device``: each config is its JAX counterpart's
    with ``over`` (such as a smaller ``max_iterations``) added, and config
    5 re-solves the window at ``center`` (host integers), from a warm
    cascade of its own config."""
    over = dict(over or {})
    dev = require_device(device)
    rgb_d = torch.from_numpy(rgb).to(dev)
    mask_d, value_d = torch.from_numpy(mask).to(dev), torch.from_numpy(value).to(dev)
    gray0 = rgb_to_gray(rgb_d)
    h, w = mask.shape
    cfg1 = DiffusionConfig(solver="jacobi", **over)
    gp = build_gray_pyramid(gray0, cfg1)

    def cascade_step(cfg):
        def step(state):
            return solve_cascade(gp, mask_d, value_d, state, cfg)[1]
        return step

    st = initial_depth_state(h, w, cfg1, dev)

    def wstep(d):
        return d + edge_weights(gray0, d, 0, 4, cfg1).inv_count * 1e-9

    cfg2 = DiffusionConfig(solver="red_black", early_exit=True, tolerance=1e-3,
                           residual_check_every=25, **over)
    cfg4 = DiffusionConfig(multigrid="vcycle", **over)

    def vstep(state):
        return solve_vcycle(gp, mask_d, value_d, state, cfg4)[1]

    cfg5 = DiffusionConfig(incremental_iterations=120, **over)
    _, warm = solve_cascade(gp, mask_d, value_d, initial_depth_state(h, w, cfg5, dev), cfg5)

    def live_step(state):
        d0, s = solve_incremental(gp, mask_d, value_d, state, center, cfg5)
        fx.apply_effect(fx.EFFECT_HAZE, rgb_d, gray0, torch.clamp(d0, 0.0, 255.0), cfg5)
        return s

    return [
        Case(NAMES[0], cfg1, cascade_step(cfg1), st, 8),
        Case(NAMES[1], cfg2, cascade_step(cfg2), initial_depth_state(h, w, cfg2, dev), 8),
        Case(NAMES[2], cfg1, wstep, st[0], 64),
        Case(NAMES[3], cfg4, vstep, initial_depth_state(h, w, cfg4, dev), 4),
        Case(NAMES[4], cfg5, live_step, warm, 32),
    ]


def config_record(name: str, ms: float, unit: str = "ms", extra: Optional[dict] = None) -> dict:
    """A stdout record in bench_configs.py's keys."""
    rec = {"metric": name, "value": round(float(ms), 3), "unit": unit}
    if extra:
        rec.update(extra)
    return rec


def early_exit_log(case: Case, rgb, mask, value, device) -> list:
    """Config 2's early exit in one frame from its initial state: the list
    ``exit_log`` of ``solve_cascade``, a dict per level whose ``probes``
    are its host reads."""
    dev = torch.device(device)
    gp = build_gray_pyramid(rgb_to_gray(torch.from_numpy(rgb).to(dev)), case.cfg)
    exit_log: list = []
    solve_cascade(gp, torch.from_numpy(mask).to(dev), torch.from_numpy(value).to(dev),
                  case.state0, case.cfg, exit_log)
    return exit_log


def run_configs(rgb, mask, value, device, over: Optional[dict] = None,
                center: Tuple[int, int] = CENTER, n: int = 3) -> List[dict]:
    """Time the five configs and emit their records; returns them."""
    records = []
    for case in config_cases(rgb, mask, value, device, over, center):
        if case.cfg.early_exit:
            reads = sum(len(e["probes"]) for e in early_exit_log(case, rgb, mask, value, device))
            log(f"{case.name}: the early exit reads {reads} residuals a frame back to the "
                f"host, one per probe "
                f"(core/solver.py:_chunked_early_exit), each a wait for the card inside the "
                f"timed chain, by the port's design")
        ms = chained_ms(case.step, case.state0, case.k, n, name=case.name)
        extra = {"within_16ms_budget": bool(ms < BUDGET_MS)} if case.name == NAMES[3] else None
        rec = config_record(case.name, ms, extra=extra)
        emit(rec)
        records.append(rec)
    return records


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="python -m realtimedepthdiffusion_tpu_torch.bench_configs",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", type=device_arg, default="cuda",
                   help="cuda (default), cuda:N or cpu; a card asked for where there is "
                        "none raises")
    a = p.parse_args(argv)
    dev = require_device(a.device)
    from .utils.cache import enable_compilation_cache

    enable_compilation_cache()
    rgb, mask, value, source = bench_inputs(1080, 1920)
    log(f"device: {dev}; input: {source}")
    run_configs(rgb, mask, value, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())

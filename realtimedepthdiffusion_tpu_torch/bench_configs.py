"""The five BASELINE configurations on the card, one JSON line each (twin of
the repository's root ``bench_configs.py``, with its metric names):

1. Jacobi scribble diffusion, fixed iterations (a cascade step)
2. Red-black Gauss-Seidel with the residual early exit
3. Edge-aware anisotropic Laplacian weights from image gradients (L0)
4. The full multigrid V-cycle at 1080p
5. The live loop: the windowed incremental re-solve and the haze effect

    python -m realtimedepthdiffusion_tpu_torch.bench_configs [--device cuda]

Each number is (t(K) - t(1)) / (K - 1) over the min of three envelopes,
each chain ending in one host readback of a reduced scalar. As the JAX
script jits each chain of K steps into one program (its ``chained_ms``), a
chain here is captured once into one CUDA graph (``captured_chain``) and
each envelope replays it, so the host launches one graph a chain. The
inputs are the headline bench's (``bench.bench_inputs``) at 1080p.

Config 2's early exit is decided on the card (``core/solver.py:
_chunked_early_exit``): every chunk is in the graph and those after a
level's exit run as no-ops, so nothing is read back inside a chain; the
probes a frame runs are logged. Config 5 takes its centre as a (2,) int32
tensor on the card, as the JAX script does, and computes the effect each
frame without tying it into the state (the JAX bench does that only to
keep XLA from dropping it).
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

from .bench import BUDGET_MS, bench_inputs, emit, envelope_ms, log, run_chain, to_host
from .config import DiffusionConfig
from .core import effects as fx
from .core.color import rgb_to_gray
from .core.incremental import solve_incremental
from .core.multigrid import build_gray_pyramid, initial_depth_state, solve_cascade, solve_vcycle
from .core.solver import read_exit_log
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
    5 re-solves the window at ``center``, uploaded once as a (2,) int32
    tensor, from a warm cascade of its own config."""
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
    center_d = torch.tensor(center, dtype=torch.int32, device=dev)

    def live_step(state):
        d0, s = solve_incremental(gp, mask_d, value_d, state, center_d, cfg5)
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
    ``exit_log`` of ``solve_cascade``, a dict per level with the
    iterations and probes it ran, read once after the solve."""
    dev = torch.device(device)
    gp = build_gray_pyramid(rgb_to_gray(torch.from_numpy(rgb).to(dev)), case.cfg)
    exit_log: list = []
    solve_cascade(gp, torch.from_numpy(mask).to(dev), torch.from_numpy(value).to(dev),
                  case.state0, case.cfg, exit_log)
    return read_exit_log(exit_log)


def captured_chain(step: Callable, state0, k: int, dev: torch.device) -> Callable:
    """A function that runs ``k`` steps from ``state0`` and reads the sum
    of every tensor of the last state back to the host (``bench.to_host``).
    On a card the chain runs once eagerly (the kernels' build or load, the
    card queries, the iteration tables on the card) and is then captured
    into one CUDA graph, which the function replays, as the JAX script
    jits the chain into one program; a step leaves its input as it was, so
    every replay starts from ``state0``. On the CPU it runs the steps."""
    leaves = (lambda s: [s]) if isinstance(state0, torch.Tensor) else list
    if dev.type != "cuda":
        return lambda: to_host(leaves(run_chain(step, state0, k)))
    run_chain(step, state0, k)
    torch.cuda.synchronize(dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = leaves(run_chain(step, state0, k))

    def replay():
        graph.replay()
        return to_host(out)

    return replay


def chained_ms(step: Callable, state0, k: int, n: int, dev: torch.device,
               name: str = "") -> float:
    """(t(k) - t(1)) / (k - 1) in ms: each envelope the least host-clock
    time of ``n`` runs of the captured 1-chain or k-chain
    (``captured_chain``), after one run of each that is not timed."""
    chains = {}
    for j in (1, k):
        t0 = time.perf_counter()
        chains[j] = captured_chain(step, state0, j, dev)
        chains[j]()
        if name:
            log(f"{name}: f{j} run, captured and replayed once: "
                f"{time.perf_counter() - t0:.1f}s")
    return (envelope_ms(chains[k], n) - envelope_ms(chains[1], n)) / (k - 1)


def run_configs(rgb, mask, value, device, over: Optional[dict] = None,
                center: Tuple[int, int] = CENTER, n: int = 3) -> List[dict]:
    """Time the five configs and emit their records; returns them."""
    records = []
    dev = torch.device(device)
    for case in config_cases(rgb, mask, value, device, over, center):
        if case.cfg.early_exit:
            exits = early_exit_log(case, rgb, mask, value, device)
            log(f"{case.name}: early exit on the card, "
                f"{sum(len(e['probes']) for e in exits)} probes and "
                f"{sum(e['iters'] for e in exits)} iterations a frame, none read back inside "
                f"the chain (core/solver.py:_chunked_early_exit)")
        ms = chained_ms(case.step, case.state0, case.k, n, dev, name=case.name)
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

"""One full multi-device step at tiny shapes (the twin of ``__graft_entry__.dryrun_multichip``)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import ops
from ..config import DiffusionConfig
from ..core import effects as fx
from . import sharded
from .mesh import make_mesh


def _block_routes(device_type: str) -> dict:
    """Blocks run per route since the last reset: the kernels' launch
    counts on a card, the block functions' calls on the CPU."""
    if device_type == "cuda":
        c = ops.launch_counts()
        return {"jacobi_chebyshev": c["jc_sweep_tiles"], "red_black": c["rb_sweep_tiles"],
                "defocus": c["defocus_block"]}
    return {k: sharded.block_calls[k] for k in ("jacobi_chebyshev", "red_black", "defocus")}


def _reset() -> None:
    ops.reset_launch_counts()
    sharded.block_calls.clear()


def dryrun_multichip(n_slots: int, *, device) -> dict:
    """Run the step on an ``n_slots`` mesh on ``device`` at 64x96 with 24
    iterations and assert the routes it took: (1) Jacobi-Chebyshev through
    the halo-block sweeps, with the sharded defocus through the block
    defocus; (2) red-black with the residual early exit; (2b, 2c) the exit
    fires at the first check under a tolerance every residual passes (0.9:
    229.5 gray levels) and runs the whole budget under an unreachable one
    (0), for red-black and for Jacobi-Chebyshev. Returns what it saw."""
    mesh = make_mesh(n_slots, device=device)
    kind = mesh.home.type
    spatial = mesh.shape["dy"] * mesh.shape["dx"] > 1
    seen = {"mesh": dict(mesh.shape)}

    cfg = DiffusionConfig(max_iterations=24)
    _reset()
    fn, make_args = sharded.batched_step(mesh, 64, 96, cfg, fx.EFFECT_DEFOCUS)
    depth, state, out = fn(*make_args(mesh.shape["batch"]))
    routes = _block_routes(kind)
    assert depth.shape[-2:] == (64, 96) and out.dtype == torch.uint8, (depth.shape, out.dtype)
    assert bool(torch.isfinite(depth).all())
    assert routes["defocus"] > 0, f"defocus did not take the block route: {routes}"
    assert routes["jacobi_chebyshev"] > 0 or not spatial, f"no halo-block sweeps ran: {routes}"
    seen["pass1"] = routes

    cfg_rb = DiffusionConfig(max_iterations=24, solver="red_black", early_exit=True,
                             residual_check_every=8)
    _reset()
    fn_rb, make_args_rb = sharded.batched_step(mesh, 64, 96, cfg_rb)
    depth_rb, _, _ = fn_rb(*make_args_rb(mesh.shape["batch"]))
    routes = _block_routes(kind)
    assert depth_rb.shape[-2:] == (64, 96) and bool(torch.isfinite(depth_rb).all())
    assert routes["red_black"] > 0 or not spatial, f"no halo-block iterations ran: {routes}"
    seen["pass2"] = routes

    rng = np.random.default_rng(7)
    gray = torch.from_numpy(rng.integers(0, 256, (64, 96), dtype=np.uint8)).to(mesh.home)
    mask = np.zeros((64, 96), bool)
    mask[10:16, 20:30] = True
    mask = torch.from_numpy(mask).to(mesh.home)
    depth0 = torch.where(mask, 32.0, 255.0).to(torch.float32)
    for solver in ("red_black", "jacobi_chebyshev"):
        done = {}
        for tol in (0.9, 0.0):
            c = dataclasses.replace(cfg_rb, solver=solver, tolerance=tol)
            _, done[tol], _ = sharded.solve_level_sharded(depth0, mask, gray, 0, 2, 24, mesh, c,
                                                           return_info=True)
        assert done[0.9] == 8, f"{solver}: the exit did not fire at the first check: {done}"
        assert done[0.0] == 24, f"{solver}: the unreachable tolerance exited early: {done}"
        seen[f"iters_done {solver}"] = [done[0.9], done[0.0]]
    return seen


"""The cascadic coarse-to-fine solve and the V-cycle (port of ``realtimedepthdiffusion_tpu/core/multigrid.py``).

``solve_cascade`` runs the level solves on the kernels or their plain
versions, by the tensors' device. The V-cycle's polish (``vcycle_polish``)
smooths its error equations through ``_smooth_error``, the one function it
calls for a pass: on a card one hand-written launch a pass
(``ops/vc_smooth.py``, routed by ``ops/dispatch.py:smooth_error``), where
the reference runs plain XLA ops; on the CPU plain torch ops. The rest of
the polish (residuals, restrictions, pyrUps, damped corrections, the
levels' weights) is plain torch ops on every device. ``solve_vcycle``
wraps the polish in the span ``vcycle.polish`` (``utils/timing.py``), and
``vcycle_work`` counts its work on the host for the session's counters.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

from ..config import DiffusionConfig
from ..ops import dispatch
from ..utils.timing import span
from .annotation import annotation_pyr_down, seed_depth
from .pyramid import pyr_down_gray, pyr_down_gray_ceil, pyr_up
from .solver import jacobi_sweep_raw, solve_level
from .weights import edge_weights


def build_gray_pyramid(gray0: torch.Tensor, cfg: DiffusionConfig) -> Tuple[torch.Tensor, ...]:
    """Gray pyramid consumed at floor sizes. "opencv" chains pyrDown at
    OpenCV's ceil sizes and crops each level to the floor size; "floor"
    chains at floor sizes."""
    h, w = gray0.shape
    levels = cfg.num_levels(h, w)
    pyr = [gray0]
    if cfg.gray_pyramid == "opencv":
        full = gray0
        for l in range(1, levels):
            full = pyr_down_gray_ceil(full)
            th, tw = cfg.level_size(h, w, l)
            pyr.append(full[:th, :tw])
    elif cfg.gray_pyramid == "floor":
        for l in range(1, levels):
            th, tw = cfg.level_size(h, w, l)
            pyr.append(pyr_down_gray(pyr[-1])[:th, :tw])
    else:
        raise ValueError(
            f"unknown gray_pyramid {cfg.gray_pyramid!r}; expected 'opencv' or 'floor'"
        )
    return tuple(p.contiguous() for p in pyr)


def build_annotation_pyramids(
    mask0: torch.Tensor, value0: torch.Tensor, cfg: DiffusionConfig
) -> Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...]]:
    """Scribble mask/value pyramids, finest first."""
    h, w = mask0.shape
    masks = [mask0]
    values = [value0]
    for l in range(1, cfg.num_levels(h, w)):
        m, v = annotation_pyr_down(masks[-1], values[-1], cfg.level_size(h, w, l))
        masks.append(m)
        values.append(v)
    return tuple(masks), tuple(values)


def initial_depth_state(rows: int, cols: int, cfg: DiffusionConfig, device) -> Tuple[torch.Tensor, ...]:
    """Fresh per-level depth maps at ``depth_init`` (255 = far): the state
    that warm-starts every later solve."""
    return tuple(
        torch.full(cfg.level_size(rows, cols, l), float(cfg.depth_init),
                   dtype=torch.float32, device=device)
        for l in range(cfg.num_levels(rows, cols))
    )


def solve_cascade(
    gray_pyr: Sequence[torch.Tensor],
    mask0: torch.Tensor,
    value0: torch.Tensor,
    depth_state: Sequence[torch.Tensor],
    cfg: DiffusionConfig = DiffusionConfig(),
    exit_log=None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """One coarse-to-fine solve; returns (depth0, new_depth_state). Level l
    runs ``cfg.level_iterations`` iterations (fewer under the early exit,
    which reports each level to the list ``exit_log``, coarsest first; on
    a card, once ``core/solver.py:read_exit_log`` has read it), then its
    pyrUp seeds level l-1."""
    levels = len(gray_pyr)
    L = levels - 1
    sizes = [tuple(g.shape) for g in gray_pyr]
    masks, values = build_annotation_pyramids(mask0, value0, cfg)

    state = list(depth_state)
    state[L] = seed_depth(state[L], masks[L], values[L])
    for level in range(L, -1, -1):
        iters = cfg.level_iterations(levels, level)
        state[level] = solve_level(
            state[level], masks[level], gray_pyr[level], level, L, iters, cfg, exit_log
        )
        if level > 0:
            up = pyr_up(state[level], sizes[level - 1])
            state[level - 1] = seed_depth(up, masks[level - 1], values[level - 1])
    return state[0], tuple(state)


def _restrict(r: torch.Tensor, out_shape: Tuple[int, int]) -> torch.Tensor:
    """2x2 full-weighting restriction onto the floor-size coarse grid: the
    four pixels of each cell of ``r[:2*oh, :2*ow]`` added in a fixed order,
    times 0.25, so that every device rounds alike."""
    oh, ow = out_shape
    r = r[: 2 * oh, : 2 * ow]
    s = r[0::2, 0::2] + r[0::2, 1::2]
    s = s + r[1::2, 0::2]
    s = s + r[1::2, 1::2]
    return 0.25 * s


def _smooth_error(e, rhs, mask, wts, sweeps: int):
    """Jacobi on the error equation (I - M) e = rhs, e = 0 on scribbles:
    one pass of ``sweeps`` sweeps, on the kernels or in torch ops by the
    device (``ops/dispatch.py:smooth_error``)."""
    return dispatch.smooth_error(e, rhs, mask, wts, sweeps)


def vcycle_warm_config(cfg: DiffusionConfig) -> DiffusionConfig:
    """The cascade that warm-starts the V-cycle: ``cfg`` as a cascadic
    config with ``vcycle_warm_fraction`` of the iteration budget, at least
    four Chebyshev warm-ups."""
    warm_iters = max(int(cfg.max_iterations * cfg.vcycle_warm_fraction), 4 * cfg.chebyshev_s)
    return dataclasses.replace(cfg, max_iterations=warm_iters, multigrid="cascadic")


def solve_vcycle(
    gray_pyr: Sequence[torch.Tensor],
    mask0: torch.Tensor,
    value0: torch.Tensor,
    depth_state: Sequence[torch.Tensor],
    cfg: DiffusionConfig = DiffusionConfig(),
    exit_log=None,
    timer=None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """The V-cycle solve: a cascadic warm start (``vcycle_warm_config``,
    through ``solve_cascade`` and so through its kernels on a card), then
    ``cfg.vcycles`` error-correction cycles at the finest level
    (``vcycle_polish``). Returns (depth0, new_depth_state); only level 0 of
    the state is polished. ``exit_log`` reports the warm cascade's levels.
    The polish runs in the span ``vcycle.polish``, which ``timer`` (a
    ``utils/timing.py:StageTimer``) accumulates where one is given: the
    host's time to launch it, in an eager solve or a capture (a replayed
    graph runs no span)."""
    _, state = solve_cascade(gray_pyr, mask0, value0, depth_state, vcycle_warm_config(cfg),
                             exit_log)
    with span("vcycle.polish", timer):
        u = vcycle_polish(gray_pyr, mask0, value0, state[0], cfg)
    return u, (u,) + tuple(state[1:])


def vcycle_work(sizes: Sequence[Tuple[int, int]],
                cfg: DiffusionConfig = DiffusionConfig()) -> Tuple[int, int, int]:
    """(cycles, pixel-sweeps, pixels) of one ``vcycle_polish`` on the levels
    of ``sizes``, finest first: each cycle visits every level once, smooths
    ``vcycle_pre_smooth`` + ``vcycle_post_smooth`` sweeps on each level but
    the coarsest and ``vcycle_coarse_iters`` there (``_smooth_error``).
    From the shapes and ``cfg`` alone, on the host."""
    px = [h * w for h, w in sizes]
    sweeps = (sum(px[:-1]) * (cfg.vcycle_pre_smooth + cfg.vcycle_post_smooth)
              + px[-1] * cfg.vcycle_coarse_iters)
    return cfg.vcycles, cfg.vcycles * sweeps, cfg.vcycles * sum(px)


def vcycle_polish(
    gray_pyr: Sequence[torch.Tensor],
    mask0: torch.Tensor,
    value0: torch.Tensor,
    u: torch.Tensor,
    cfg: DiffusionConfig = DiffusionConfig(),
) -> torch.Tensor:
    """``cfg.vcycles`` error-correction V-cycles on a warm fine solution.
    Each cycle pre-smooths, restricts the residual, solves the linear,
    unclipped error equation on the coarser grids in turn, prolongs and
    corrects with the optimal damping, and post-smooths. Scribbled pixels
    are Dirichlet constraints at every level (the error is 0 there), and u
    ends each cycle clipped to [0, 255]. Everything stays on the device of
    ``u``: the damping factors are 0-d tensors, never read by the host."""
    levels = len(gray_pyr)
    L = levels - 1
    sizes = [tuple(g.shape) for g in gray_pyr]
    masks, _ = build_annotation_pyramids(mask0, value0, cfg)

    # The operator of each level, fixed for all cycles: weights from the
    # warm fine solution restricted down the pyramid.
    wts = []
    d = u
    for l in range(levels):
        if l > 0:
            d = _restrict(d, sizes[l])
        wts.append(edge_weights(gray_pyr[l], d, l, L, cfg))

    def _apply_A(e, level):
        """A = I - M off the scribbles (e and A e are 0 on them)."""
        return torch.where(masks[level], 0.0, e - jacobi_sweep_raw(e, wts[level]))

    def _damped_add(e, corr, rhs_res, level):
        """e + alpha*corr with alpha = <r, A c> / <A c, A c>, the damping
        under which the L2 residual cannot grow, although the coarse
        operator is rediscretized and only approximates the fine one."""
        corr = torch.where(masks[level], 0.0, corr)
        ac = _apply_A(corr, level)
        denom = (ac * ac).sum()
        alpha = torch.where(denom > 0, (rhs_res * ac).sum() / denom.clamp_min(1e-30), 0.0)
        return e + alpha * corr

    def cycle_err(rhs, level):
        """An approximate solution e of (I - M_level) e = rhs."""
        e = torch.zeros(sizes[level], dtype=torch.float32, device=rhs.device)
        if level == L:
            return _smooth_error(e, rhs, masks[level], wts[level], cfg.vcycle_coarse_iters)
        e = _smooth_error(e, rhs, masks[level], wts[level], cfg.vcycle_pre_smooth)
        r = rhs - _apply_A(e, level)
        rc = torch.where(masks[level + 1], 0.0, _restrict(r, sizes[level + 1]))
        ec = cycle_err(rc, level + 1)
        e = _damped_add(e, pyr_up(ec, sizes[level]), r, level)
        return _smooth_error(e, rhs, masks[level], wts[level], cfg.vcycle_post_smooth)

    u = u.to(torch.float32)
    for _ in range(cfg.vcycles):
        r = torch.where(masks[0], 0.0, jacobi_sweep_raw(u, wts[0]) - u)
        e = cycle_err(r, 0)
        u = _damped_add(u, e, r, 0)
        u = torch.clamp(u, 0.0, 255.0)
    return u

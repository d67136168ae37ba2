"""The cascadic coarse-to-fine solve (port of ``realtimedepthdiffusion_tpu/core/multigrid.py:31-134``).

The V-cycle (``solve_vcycle``) is not ported yet (ROADMAP A9).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..config import DiffusionConfig
from .annotation import annotation_pyr_down, seed_depth
from .pyramid import pyr_down_gray, pyr_down_gray_ceil, pyr_up
from .solver import solve_level


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
    which reports each level to the list ``exit_log``, coarsest first),
    then its pyrUp seeds level l-1."""
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

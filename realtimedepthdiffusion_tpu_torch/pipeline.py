"""The solve and effect pipeline for one image size (port of
``realtimedepthdiffusion_tpu/pipeline.py:219-325, 599-712``).

PyTorch runs eagerly, so there is nothing to compile ahead and nothing to
hide: the reference's staged cold start, AOT executables and background
compiles have no counterpart here. Every tensor lives on the pipeline's
``device``; on a CUDA device the sweeps and the defocus run the port's
kernels, on the CPU their plain versions.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from .config import DiffusionConfig
from .core import effects as fx
from .core.color import rgb_to_gray
from .core.multigrid import build_gray_pyramid, initial_depth_state, solve_cascade
from .ops import dispatch


class DepthPipeline:
    """Solve and effect for one (rows, cols, cfg) on one ``device``, which
    the caller names: nothing here picks the CPU or a card by itself.

    Callers carry the depth-state pyramid from solve to solve; it
    warm-starts the next solve.
    """

    def __init__(self, rows: int, cols: int, cfg: DiffusionConfig = DiffusionConfig(), *,
                 device):
        dispatch.check_supported(cfg)
        self.rows, self.cols, self.cfg = rows, cols, cfg
        self.device = torch.device(device)
        self.levels = cfg.num_levels(rows, cols)

    def prepare_image(self, rgb_u8) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        """Upload the (H,W,3) uint8 image once; returns (rgb, gray_pyramid)."""
        if isinstance(rgb_u8, np.ndarray):
            rgb_u8 = torch.from_numpy(np.ascontiguousarray(rgb_u8))
        rgb = rgb_u8.to(device=self.device, dtype=torch.uint8)
        return rgb, build_gray_pyramid(rgb_to_gray(rgb), self.cfg)

    def initial_state(self) -> Tuple[torch.Tensor, ...]:
        return initial_depth_state(self.rows, self.cols, self.cfg, self.device)

    def solve(self, gray_pyr: Sequence[torch.Tensor], mask0: torch.Tensor,
              value0: torch.Tensor, depth_state: Sequence[torch.Tensor]):
        """Full cascadic solve; returns (depth0_f32, new_depth_state)."""
        return solve_cascade(gray_pyr, mask0, value0, depth_state, self.cfg)

    def solve_and_effect(self, effect: int, gray_pyr, rgb, mask0, value0, depth_state):
        """Solve, then the effect on the clipped depth; returns
        (depth0, new_state, effect_rgb_u8)."""
        depth0, state = self.solve(gray_pyr, mask0, value0, depth_state)
        # The unclamped Chebyshev update can overshoot [0, 255] slightly.
        out = self.effect(effect, rgb, gray_pyr[0], torch.clamp(depth0, 0.0, 255.0))
        return depth0, state, out

    def effect(self, effect: int, rgb, gray0, depth0) -> torch.Tensor:
        return fx.apply_effect(effect, rgb, gray0, depth0, self.cfg)

    def depth_u8(self, depth0: torch.Tensor) -> torch.Tensor:
        """float32 depth -> uint8 (round half to even, like ``jnp.rint``)."""
        return torch.clamp(torch.round(depth0), 0, 255).to(torch.uint8)


@functools.lru_cache(maxsize=8)
def get_pipeline(rows: int, cols: int, cfg: DiffusionConfig = DiffusionConfig(), *,
                 device) -> DepthPipeline:
    """Pipeline cache keyed by (shape, config, device)."""
    return DepthPipeline(rows, cols, cfg, device=device)

"""The solve and effect pipeline for one image size (port of
``realtimedepthdiffusion_tpu/pipeline.py:219-325, 599-712``).

PyTorch runs eagerly, so there is nothing to compile ahead and nothing to
hide: the reference's staged cold start, AOT executables and background
compiles have no counterpart here. Every tensor lives on the pipeline's
``device``; on a CUDA device the sweeps and the defocus run the port's
kernels, on the CPU their plain versions. Every solver of
``cfg.solver`` runs, with or without the residual early exit, under both
multigrid schemes (``cfg.multigrid``: the cascade or the V-cycle), and the
windowed incremental re-solve of the live loop (``core/incremental.py``).
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from .config import DiffusionConfig
from .core import effects as fx
from .core.color import rgb_to_gray
from .core.incremental import clamp_origin, host_yx, solve_incremental
from .core.multigrid import (build_annotation_pyramids, build_gray_pyramid,
                             initial_depth_state, solve_cascade, solve_vcycle)
from .core.solver import residual_norm, residual_rms
from .core.weights import edge_weights
from .ops import dispatch


class DepthPipeline:
    """Solve and effect for one (rows, cols, cfg) on one ``device``, which
    the caller names: nothing here picks the CPU or a card by itself.

    Callers carry the depth-state pyramid from solve to solve; it
    warm-starts the next solve. ``depth_u8`` and ``depth_u16`` read a depth
    out as integers, and ``residuals`` shows how far each level of a depth
    state is from converged.
    """

    def __init__(self, rows: int, cols: int, cfg: DiffusionConfig = DiffusionConfig(), *,
                 device):
        dispatch.check_supported(cfg)
        self.rows, self.cols, self.cfg = rows, cols, cfg
        self.device = torch.device(device)
        self.levels = cfg.num_levels(rows, cols)
        self._scheme = solve_vcycle if cfg.multigrid == "vcycle" else solve_cascade

    def prepare_image(self, rgb_u8) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        """Upload the (H,W,3) uint8 image once; returns (rgb, gray_pyramid).
        The returned rgb is a copy on every device: a later change of the
        caller's array does not reach it."""
        if isinstance(rgb_u8, np.ndarray):
            rgb_u8 = torch.from_numpy(np.ascontiguousarray(rgb_u8))
        rgb = rgb_u8.to(device=self.device, dtype=torch.uint8, copy=True)
        return rgb, build_gray_pyramid(rgb_to_gray(rgb), self.cfg)

    def initial_state(self) -> Tuple[torch.Tensor, ...]:
        return initial_depth_state(self.rows, self.cols, self.cfg, self.device)

    def solve(self, gray_pyr: Sequence[torch.Tensor], mask0: torch.Tensor,
              value0: torch.Tensor, depth_state: Sequence[torch.Tensor], exit_log=None):
        """Full solve by the scheme ``cfg.multigrid`` names; returns (depth0_f32,
        new_depth_state). Under the early exit, a list given as ``exit_log``
        receives each level's iterations and probes
        (``core/solver.py:_chunked_early_exit``)."""
        return self._scheme(gray_pyr, mask0, value0, depth_state, self.cfg, exit_log)

    def solve_and_effect(self, effect: int, gray_pyr, rgb, mask0, value0, depth_state,
                         exit_log=None):
        """Solve, then the effect on the clipped depth; returns
        (depth0, new_state, effect_rgb_u8)."""
        depth0, state = self.solve(gray_pyr, mask0, value0, depth_state, exit_log)
        # The unclamped Chebyshev update can overshoot [0, 255] slightly.
        out = self.effect(effect, rgb, gray_pyr[0], torch.clamp(depth0, 0.0, 255.0))
        return depth0, state, out

    def solve_incremental(self, gray_pyr, mask0, value0, depth_state, center_yx,
                          exit_log=None):
        """Windowed warm re-solve around an edit at ``center_yx`` (level-0
        coordinates, host integers; ``core/incremental.py``); returns
        (depth0, new_state). ``depth_state`` comes from an earlier solve and
        stays valid."""
        return solve_incremental(gray_pyr, mask0, value0, depth_state, center_yx, self.cfg,
                                 exit_log)

    def solve_incremental_and_effect(self, effect: int, gray_pyr, rgb, mask0, value0,
                                     depth_state, center_yx, exit_log=None):
        """``solve_incremental``, then the effect on the clipped depth;
        returns (depth0, new_state, effect_rgb_u8)."""
        depth0, state = self.solve_incremental(gray_pyr, mask0, value0, depth_state, center_yx,
                                               exit_log)
        out = self.effect(effect, rgb, gray_pyr[0], torch.clamp(depth0, 0.0, 255.0))
        return depth0, state, out

    def update_annotation_window(self, mask_d, value_d, mask_win, value_win, origin):
        """The annotation planes with a dirty window written in at ``origin``
        (host integers), so that the host uploads only the window's bytes.
        An origin that would put the window past an edge is moved inside,
        as ``solve_incremental`` moves its window. Returns new (mask, value)
        planes; the given ones are not changed."""
        h, w = mask_d.shape
        wh, ww = mask_win.shape
        oy, ox = clamp_origin(*host_yx("origin", origin), wh, ww, h, w)
        mask_d, value_d = mask_d.clone(), value_d.clone()
        mask_d[oy:oy + wh, ox:ox + ww] = torch.as_tensor(mask_win).to(mask_d)
        value_d[oy:oy + wh, ox:ox + ww] = torch.as_tensor(value_win).to(value_d)
        return mask_d, value_d

    def effect(self, effect: int, rgb, gray0, depth0) -> torch.Tensor:
        return fx.apply_effect(effect, rgb, gray0, depth0, self.cfg)

    def depth_u8(self, depth0: torch.Tensor) -> torch.Tensor:
        """float32 depth -> uint8 (round half to even, like ``jnp.rint``)."""
        return torch.clamp(torch.round(depth0), 0, 255).to(torch.uint8)

    def depth_u16(self, depth0: torch.Tensor) -> torch.Tensor:
        """float32 depth -> uint16, clip(rint(d * 257), 0, 65535). uint16
        has few ops in torch, so the clip is in float32 and the cast goes
        through int32."""
        u16 = torch.clamp(torch.round(depth0 * 257.0), 0, 65535)
        return u16.to(torch.int32).to(torch.uint16)

    def residuals(self, gray_pyr, mask0, value0, depth_state) -> torch.Tensor:
        """Per-level residuals of a depth state, a (2, levels) float32
        tensor: the max norm in row 0 and the rms in row 1 (the one
        ``residual_metric='rms'`` gates on)."""
        masks, _ = build_annotation_pyramids(mask0, value0, self.cfg)
        L = len(gray_pyr) - 1
        res = []
        for l in range(len(gray_pyr)):
            wts = edge_weights(gray_pyr[l], depth_state[l], l, L, self.cfg)
            res.append(torch.stack([residual_norm(depth_state[l], masks[l], wts),
                                    residual_rms(depth_state[l], masks[l], wts)]))
        return torch.stack(res, dim=1)


@functools.lru_cache(maxsize=8)
def get_pipeline(rows: int, cols: int, cfg: DiffusionConfig = DiffusionConfig(), *,
                 device) -> DepthPipeline:
    """Pipeline cache keyed by (shape, config, device)."""
    return DepthPipeline(rows, cols, cfg, device=device)

"""The depth-diffusion model facade and its preconfigured families (port of ``realtimedepthdiffusion_tpu/models/depth_diffusion.py``).

A "model" binds a DiffusionConfig to pipelines on one device and exposes the
task-level API: annotate -> solve -> render, numpy in and numpy out. All
families share their weights (the edge-aware Laplacian derived from the
image); they differ in smoother and multigrid scheme.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import DiffusionConfig
from ..core import effects as fx
from ..pipeline import DepthPipeline


class DepthDiffusionModel:
    """Task-level facade over the pipeline, on the ``device`` the caller
    names (a required keyword, as on ``DepthPipeline``).

    >>> model = ChebyshevCascade(device="cuda")
    >>> depth = model.solve(rgb, mask, value)          # (H,W) float32
    >>> art = model.render(rgb, depth, effect="h")     # uint8 RGB

    Images, annotations and results are numpy arrays; a depth state is the
    pipeline's tuple of tensors on the device. A state passed in stays
    valid: every solve returns new tensors and changes none it was given.
    """

    config: DiffusionConfig = DiffusionConfig()

    def __init__(self, config: Optional[DiffusionConfig] = None, *, device, **overrides):
        cfg = config if config is not None else self.config
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        self.cfg = cfg
        self.device = torch.device(device)
        self._pipes = {}
        self._cache = {}

    _EFFECTS = {
        "b": fx.EFFECT_DEFOCUS, "g": fx.EFFECT_DESATURATION, "h": fx.EFFECT_HAZE,
    }

    def _pipe(self, h: int, w: int) -> DepthPipeline:
        key = (h, w)
        if key not in self._pipes:
            self._pipes[key] = DepthPipeline(h, w, self.cfg, device=self.device)
        return self._pipes[key]

    def _prepared(self, rgb: np.ndarray, pipe: DepthPipeline):
        """The latest prepared image (rgb on the device and its gray
        pyramid), cached across calls so that a solve -> render loop
        uploads and builds the pyramid once. The cache keeps the source
        array and matches it by identity, so a recycled ``id()`` never
        aliases another image; identity cannot see a change made in place,
        though: a caller that overwrites a buffer's pixels (``rgb[:] =
        next_frame``) passes a new array per image, or calls
        ``invalidate_image_cache()`` after the change."""
        cached = self._cache.get("img")
        if cached is not None and cached[0] is rgb:
            return cached[1]
        prepared = pipe.prepare_image(np.asarray(rgb, dtype=np.uint8))
        self._cache = {"img": (rgb, prepared)}
        return prepared

    def invalidate_image_cache(self) -> None:
        """Drop the prepared-image cache: needed only after an rgb buffer
        was changed in place and is passed again as the same object."""
        self._cache = {}

    def _annotation(self, mask, value) -> Tuple[torch.Tensor, torch.Tensor]:
        return (torch.from_numpy(np.ascontiguousarray(mask, dtype=bool)).to(self.device),
                torch.from_numpy(np.ascontiguousarray(value, dtype=np.uint8)).to(self.device))

    def solve(
        self,
        rgb: np.ndarray,
        mask: np.ndarray,
        value: np.ndarray,
        depth_state: Optional[Tuple] = None,
    ) -> np.ndarray:
        """One full solve; returns the float32 depth map. Pass the
        ``depth_state`` that ``solve_with_state`` returned to warm-start."""
        depth, _ = self.solve_with_state(rgb, mask, value, depth_state)
        return depth

    def solve_with_state(self, rgb, mask, value, depth_state=None):
        """``solve`` that also returns the new depth state."""
        h, w = rgb.shape[:2]
        pipe = self._pipe(h, w)
        _, gpyr = self._prepared(rgb, pipe)
        if depth_state is None:
            depth_state = pipe.initial_state()
        depth, state = pipe.solve(gpyr, *self._annotation(mask, value), depth_state)
        return depth.cpu().numpy(), state

    def render(self, rgb: np.ndarray, depth: np.ndarray, effect: str = "h") -> np.ndarray:
        """Render a depth effect: 'b' refocus, 'g' desaturation, 'h' haze.
        Shares ``solve``'s prepared-image cache."""
        h, w = rgb.shape[:2]
        pipe = self._pipe(h, w)
        eff = self._EFFECTS[effect]
        rgb_d, gpyr = self._prepared(rgb, pipe)
        depth_d = torch.from_numpy(np.ascontiguousarray(depth, dtype=np.float32)).to(self.device)
        out = pipe.effect(eff, rgb_d, gpyr[0], torch.clamp(depth_d, 0.0, 255.0))
        return out.cpu().numpy()

    def solve_and_render(self, rgb, mask, value, effect: str = "h",
                         depth_state: Optional[Tuple] = None):
        """Solve and effect in one call (the live loop's frame): returns
        (depth f32, art u8, depth_state). Warm-start by passing the
        returned state back in."""
        h, w = rgb.shape[:2]
        pipe = self._pipe(h, w)
        rgb_d, gpyr = self._prepared(rgb, pipe)
        if depth_state is None:
            depth_state = pipe.initial_state()
        depth, state, art = pipe.solve_and_effect(
            self._EFFECTS[effect], gpyr, rgb_d, *self._annotation(mask, value), depth_state)
        return depth.cpu().numpy(), art.cpu().numpy(), state

    def solve_incremental(self, rgb, mask, value, depth_state, center_yx):
        """Warm windowed re-solve around a small edit centred at
        ``center_yx`` (level-0 coordinates; a pair of ints or a numpy
        array): only an ``incremental_window``-sized window is re-solved at
        the fine pyramid levels, and the coarse levels' change is injected
        (``core/incremental.py``). Needs the ``depth_state`` of an earlier
        full solve; returns (depth f32, new_state)."""
        h, w = rgb.shape[:2]
        pipe = self._pipe(h, w)
        _, gpyr = self._prepared(rgb, pipe)
        depth, state = pipe.solve_incremental(gpyr, *self._annotation(mask, value), depth_state,
                                              np.asarray(center_yx).tolist())
        return depth.cpu().numpy(), state


class ChebyshevCascade(DepthDiffusionModel):
    """The reference algorithm: cascadic multigrid, Jacobi + Chebyshev."""

    config = DiffusionConfig(solver="jacobi_chebyshev", multigrid="cascadic")


class JacobiCascade(DepthDiffusionModel):
    """Plain Jacobi smoother."""

    config = DiffusionConfig(solver="jacobi", multigrid="cascadic")


class RedBlackCascade(DepthDiffusionModel):
    """Red-black Gauss-Seidel with the residual early exit."""

    config = DiffusionConfig(solver="red_black", early_exit=True, multigrid="cascadic")


class VCycle(DepthDiffusionModel):
    """Full multigrid V-cycle."""

    config = DiffusionConfig(multigrid="vcycle")

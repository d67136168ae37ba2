"""Depth effects (port of ``realtimedepthdiffusion_tpu/core/effects.py``).

Desaturation and haze are plain torch. The defocus routes by device: the
plain ``defocus_sat`` on the CPU, kernel K3 on a CUDA tensor
(``ops/defocus.py``, which also holds the half-width and quality logic
re-exported here).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DiffusionConfig
from ..ops.defocus import (  # noqa: F401  (re-exported: the reference's names)
    defocus_box,
    defocus_candidates,
    defocus_sat,
    resolved_defocus_quality,
    snap_half_widths,
)

EFFECT_NONE = 0
EFFECT_DEFOCUS = 1
EFFECT_DESATURATION = 2
EFFECT_HAZE = 3


def _c255(like: torch.Tensor) -> torch.Tensor:
    """255 as a device tensor: on CUDA, torch divides by a Python scalar as a
    multiply by its reciprocal, not the IEEE divide the reference uses."""
    return torch.full((), 255.0, device=like.device)


def desaturation(rgb: torch.Tensor, gray: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """f = depth/255; out = f*gray + (1-f)*color (far pixels fade to gray)."""
    f = (depth.to(torch.float32) / _c255(depth))[..., None]
    out = f * gray.to(torch.float32)[..., None] + (1.0 - f) * rgb.to(torch.float32)
    return torch.clamp(out, 0.0, 255.0).to(torch.uint8)


def haze(rgb: torch.Tensor, depth: torch.Tensor, cfg: DiffusionConfig = DiffusionConfig()) -> torch.Tensor:
    """t = exp(-haze_beta * depth/255); out = t*color + (1-t)*airlight."""
    beta = float(np.float32(cfg.haze_beta))
    t = torch.exp(-beta * depth.to(torch.float32) / _c255(depth))[..., None]
    out = t * rgb.to(torch.float32) + (1.0 - t) * float(np.float32(cfg.haze_airlight))
    return torch.clamp(out, 0.0, 255.0).to(torch.uint8)


def defocus(rgb: torch.Tensor, depth: torch.Tensor, cfg: DiffusionConfig = DiffusionConfig()) -> torch.Tensor:
    """Depth-proportional box blur: K3 on a CUDA tensor, ``defocus_sat`` on the CPU."""
    if depth.is_cuda:
        return defocus_box(rgb, depth, cfg)
    return defocus_sat(rgb, depth, cfg)


def apply_effect(effect: int, rgb: torch.Tensor, gray: torch.Tensor, depth: torch.Tensor,
                 cfg: DiffusionConfig = DiffusionConfig()) -> torch.Tensor:
    """Dispatch over the effect modes; EFFECT_NONE returns ``rgb``."""
    if effect == EFFECT_DEFOCUS:
        return defocus(rgb, depth, cfg)
    if effect == EFFECT_DESATURATION:
        return desaturation(rgb, gray, depth)
    if effect == EFFECT_HAZE:
        return haze(rgb, depth, cfg)
    return rgb

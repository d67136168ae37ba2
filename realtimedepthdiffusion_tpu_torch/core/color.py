"""Color conversion (port of ``realtimedepthdiffusion_tpu/core/color.py``)."""

from __future__ import annotations

import torch


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """RGB (H,W,3) uint8 -> gray (H,W) uint8, OpenCV's fixed-point luma:
    (R*9798 + G*19235 + B*3735 + 16384) >> 15. Integer, so exact."""
    x = rgb.to(torch.int32)
    acc = x[..., 0] * 9798 + x[..., 1] * 19235 + x[..., 2] * 3735 + 16384
    return (acc >> 15).to(torch.uint8)

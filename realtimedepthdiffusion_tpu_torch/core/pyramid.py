"""Image pyramids (port of ``realtimedepthdiffusion_tpu/core/pyramid.py``).

pyrDown is OpenCV's 8-bit fixed-point Gaussian (5-tap [1,4,6,4,1]/16 per
axis, reflect-101 border, round half up): integer, so exact. pyrUp is the
float32 zero-insert + 5-tap filter with OpenCV's axis-asymmetric odd-size
extension.
"""

from __future__ import annotations

from typing import Tuple

import torch

_KI = (1, 4, 6, 4, 1)


def _reflect101_index(n: int, pad: int, device) -> torch.Tensor:
    """Source indices of a reflect-101 pad of ``pad`` on both ends (numpy's
    'reflect' mode) of an axis of length ``n``."""
    i = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * n - 2
    m = torch.remainder(i, period)
    return torch.where(m < n, m, period - m)


def _reflect_pad(a: torch.Tensor, pad: int, dim: int) -> torch.Tensor:
    return a.index_select(dim, _reflect101_index(a.shape[dim], pad, a.device))


def _pyr_down_gray_to(gray: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    p = _reflect_pad(_reflect_pad(gray, 2, 0), 2, 1).to(torch.int32)
    # Slice ends past the array clamp, which on an odd axis at the ceil size
    # still yields exactly oh/ow samples: the last tap lands on the pad.
    acc = sum(_KI[t] * p[:, t : t + 2 * ow : 2] for t in range(5))
    out = sum(_KI[t] * acc[t : t + 2 * oh : 2, :] for t in range(5))
    return ((out + 128) >> 8).to(torch.uint8)


def pyr_down_gray(gray: torch.Tensor) -> torch.Tensor:
    """uint8 Gaussian pyrDown to the floor size (H//2, W//2)."""
    h, w = gray.shape
    return _pyr_down_gray_to(gray, h // 2, w // 2)


def pyr_down_gray_ceil(gray: torch.Tensor) -> torch.Tensor:
    """uint8 Gaussian pyrDown to OpenCV's ceil size ((H+1)//2, (W+1)//2),
    the chain that ``gray_pyramid="opencv"`` crops to floor sizes."""
    h, w = gray.shape
    return _pyr_down_gray_to(gray, (h + 1) // 2, (w + 1) // 2)


def _axis_up(a: torch.Tensor, n_out: int, odd_copy_out: bool) -> torch.Tensor:
    """pyrUp along dim 0: zero-insert, reflect-101 pad, 5-tap filter x 1/8."""
    h = a.shape[0]
    z = torch.stack([a, torch.zeros_like(a)], dim=1).reshape((2 * h,) + a.shape[1:])
    zp = _reflect_pad(z, 2, 0)
    out = (
        zp[0 : 2 * h]
        + 4.0 * zp[1 : 2 * h + 1]
        + 6.0 * zp[2 : 2 * h + 2]
        + 4.0 * zp[3 : 2 * h + 3]
        + zp[4 : 2 * h + 4]
    ) * 0.125
    if n_out == 2 * h + 1:
        # OpenCV's odd-size extension: an odd height copies the previous even
        # output row; an odd width takes the last source column at full weight.
        extra = out[2 * h - 2 : 2 * h - 1] if odd_copy_out else a[h - 1 : h]
        out = torch.cat([out, extra], dim=0)
    return out[:n_out]


def pyr_up(src: torch.Tensor, out_shape: Tuple[int, int]) -> torch.Tensor:
    """float32 Gaussian pyrUp to an explicit (2h or 2h+1, 2w or 2w+1) size."""
    oh, ow = out_shape
    x = src.to(torch.float32)
    t = _axis_up(x, oh, odd_copy_out=True)
    return _axis_up(t.transpose(0, 1), ow, odd_copy_out=False).transpose(0, 1).contiguous()

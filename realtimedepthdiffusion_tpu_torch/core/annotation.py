"""Annotation (scribble) ops (port of ``realtimedepthdiffusion_tpu/core/annotation.py``).

An annotation is the pair (mask: bool HxW, value: uint8 HxW).
"""

from __future__ import annotations

from typing import Tuple

import torch


def annotation_pyr_down(
    mask: torch.Tensor, value: torch.Tensor, out_shape: Tuple[int, int]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Downsample an annotation one pyramid level.

    Coarse (y, x) scans fine {2y-1, 2y} x {2x-1, 2x} in row-major order: any
    masked fine pixel masks the coarse pixel, and the LAST masked one in
    scan order supplies the value. Each masked pixel carries the packed key
    ((rank + 1) << 8) | value, with rank 2*(row even) + (col even) unique in
    its window, so a max over the window picks the last writer. The max is a
    reshape plus ``amax``: ``max_pool2d`` takes no int32 on the CPU.
    """
    oh, ow = out_shape
    h, w = mask.shape
    dev = mask.device
    ry = 1 - (torch.arange(h, device=dev, dtype=torch.int32) & 1)
    rx = 1 - (torch.arange(w, device=dev, dtype=torch.int32) & 1)
    rank = 2 * ry[:, None] + rx[None, :]
    packed = torch.where(
        mask, ((rank + 1) << 8) | value.to(torch.int32), torch.zeros_like(rank)
    )
    # Window {2y-1, 2y}: one zero row/column on top/left, then enough at the
    # bottom/right to cover 2*oh rows and 2*ow columns.
    p = torch.nn.functional.pad(packed, (1, 2 * ow - w + 1, 1, 2 * oh - h + 1))
    win = p[: 2 * oh, : 2 * ow].reshape(oh, 2, ow, 2).amax(dim=(1, 3))
    return win != 0, (win & 255).to(torch.uint8)


def seed_depth(depth: torch.Tensor, mask: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """Dirichlet seeding: the scribble value where masked, else the depth."""
    return torch.where(mask, value.to(torch.float32), depth.to(torch.float32))


def paint(
    mask: torch.Tensor, value: torch.Tensor, x: int, y: int, color: int, radius: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Square-brush paint on the planes' device: new (mask, value) with the
    pixels |px - x| <= radius // 2 and |py - y| <= radius // 2 set to
    ``color`` (a negative radius paints one pixel). The given planes are not
    changed. The live session paints its host planes through the native
    runtime instead (``native/runtime.py:NativeRuntime.paint``), which this
    equals."""
    h, w = mask.shape
    half = max(int(radius), 0) // 2
    yy = torch.arange(h, device=mask.device)[:, None]
    xx = torch.arange(w, device=mask.device)[None, :]
    hit = ((xx - int(x)).abs() <= half) & ((yy - int(y)).abs() <= half)
    color_t = torch.full((), int(color), dtype=torch.uint8, device=value.device)
    return mask | hit, torch.where(hit, color_t, value)

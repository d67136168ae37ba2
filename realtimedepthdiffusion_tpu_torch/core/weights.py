"""Edge-aware Laplacian weights (port of ``realtimedepthdiffusion_tpu/core/weights.py``).

Four float32 neighbour-weight planes plus the reciprocal of their sum,
computed once per level in plain torch; the sweep kernels only read them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import DiffusionConfig

# The float32 normal/subnormal boundary. Both pins below sit here so that
# CPU (which keeps subnormals) and a device that flushes them agree on
# which weights vanish and which pixels are isolated.
_TINY = float(np.finfo(np.float32).tiny)


class EdgeWeights(NamedTuple):
    """Per-pixel neighbour weights and the reciprocal of their sum."""

    wl: torch.Tensor  # toward (y, x-1), 0 at x == 0
    wr: torch.Tensor  # toward (y, x+1), 0 at x == W-1
    wu: torch.Tensor  # toward (y-1, x), 0 at y == 0
    wd: torch.Tensor  # toward (y+1, x), 0 at y == H-1
    inv_count: torch.Tensor  # 1/(wl+wr+wu+wd), 0 where the sum is subnormal


def _pad_edge_pairs(bh: torch.Tensor, bv: torch.Tensor) -> EdgeWeights:
    pad = torch.nn.functional.pad
    wl = pad(bh, (1, 0))
    wr = pad(bh, (0, 1))
    wu = pad(bv, (0, 0, 1, 0))
    wd = pad(bv, (0, 0, 0, 1))
    count = wl + wr + wu + wd
    inv_count = torch.where(count >= _TINY, 1.0 / count, torch.zeros_like(count))
    return EdgeWeights(wl, wr, wu, wd, inv_count)


def level_d8(depth: torch.Tensor) -> torch.Tensor:
    """The depth the threshold rule compares: clip to [0, 255], then
    truncate to uint8. It is taken once per level, from the incoming depth."""
    return torch.clamp(depth, 0.0, 255.0).to(torch.uint8)


def depth_threshold(level: int, max_level: int, cfg: DiffusionConfig) -> int | None:
    """The threshold of a level's depth rule: 0 at level 0,
    ``cfg.depth_edge_threshold`` above it, None (no rule) at the coarsest."""
    if level == max_level:
        return None
    return 0 if level == 0 else int(cfg.depth_edge_threshold)


def weights_from_base(base_h: torch.Tensor, base_v: torch.Tensor, d8: torch.Tensor | None,
                      level: int, max_level: int, cfg: DiffusionConfig) -> EdgeWeights:
    """The level's weights from the gray base weights of each horizontal
    and vertical pair: 1.0 where the level has a depth rule and the ``d8``
    of the pair differ by at most its threshold."""
    thr = depth_threshold(level, max_level, cfg)
    if thr is None:
        return _pad_edge_pairs(base_h, base_v)
    d = d8.to(torch.int32)
    one = torch.ones((), dtype=torch.float32, device=base_h.device)
    bh = torch.where((d[:, 1:] - d[:, :-1]).abs() > thr, base_h, one)
    bv = torch.where((d[1:, :] - d[:-1, :]).abs() > thr, base_v, one)
    return _pad_edge_pairs(bh, bv)


def edge_weights(
    gray: torch.Tensor,
    depth: torch.Tensor | None,
    level: int,
    max_level: int,
    cfg: DiffusionConfig = DiffusionConfig(),
) -> EdgeWeights:
    """5-point stencil weights for one pyramid level.

    Coarsest level: w = exp(-beta * |gray(p) - gray(q)|). Finer levels: the
    same where the uint8-truncated clipped depth differs by more than the
    threshold (4; 0 at level 0), else 1.0.
    """
    g = gray.to(torch.int32)
    gsad_h = (g[:, 1:] - g[:, :-1]).abs().to(torch.float32)
    gsad_v = (g[1:, :] - g[:-1, :]).abs().to(torch.float32)
    nbeta = -float(np.float32(cfg.beta))
    base_h = torch.exp(nbeta * gsad_h)
    base_v = torch.exp(nbeta * gsad_v)
    zero = torch.zeros((), dtype=torch.float32, device=g.device)
    base_h = torch.where(base_h >= _TINY, base_h, zero)
    base_v = torch.where(base_v >= _TINY, base_v, zero)
    d8 = None if level == max_level else level_d8(depth)
    return weights_from_base(base_h, base_v, d8, level, max_level, cfg)

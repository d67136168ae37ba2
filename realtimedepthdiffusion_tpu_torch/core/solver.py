"""The per-level Jacobi-Chebyshev solve (port of ``realtimedepthdiffusion_tpu/core/solver.py``).

The port computes the Chebyshev update in the (a, b, c) form of the Pallas
kernels (``ops/pallas_sweep.py:_sweep_full``), ``a*r + b*u + c*prev``, not
the reference's XLA form ``omega*(gamma*(r-u)+u-prev)+prev``: the two are
equal in exact arithmetic and differ in rounding.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DiffusionConfig
from ..ops import dispatch
from .weights import edge_weights


def chebyshev_omegas(iters: int, cfg: DiffusionConfig = DiffusionConfig()) -> np.ndarray:
    """Per-iteration omega schedule: 1 for the first S sweeps, then
    2/(2-rho^2), then the recurrence 4/(4-rho^2*omega), stored in float32
    with float64 update arithmetic (C semantics of the original CUDA code)."""
    s = cfg.chebyshev_s
    rho2 = np.float32(cfg.chebyshev_rho) * np.float32(cfg.chebyshev_rho)
    out = np.empty(max(iters, 1), dtype=np.float32)
    omega = np.float32(0.0)
    for i in range(max(iters, 1)):
        if i < s:
            omega = np.float32(1.0)
        elif i == s:
            omega = np.float32(2.0 / (2.0 - np.float64(rho2)))
        else:
            omega = np.float32(4.0 / (4.0 - np.float64(rho2 * omega)))
        out[i] = omega
    return out[:iters]


def abc_schedule(iters: int, cfg: DiffusionConfig = DiffusionConfig()) -> np.ndarray:
    """(iters, 3) float32 rows (a, b, c) = (omega*gamma, omega - a, 1 - omega)."""
    om = chebyshev_omegas(iters, cfg).astype(np.float32)
    g = np.float32(cfg.chebyshev_gamma)
    a = om * g
    return np.stack([a, om - a, np.float32(1.0) - om], axis=1)


def solve_level(
    depth: torch.Tensor,
    mask: torch.Tensor,
    gray: torch.Tensor,
    level: int,
    max_level: int,
    iters: int,
    cfg: DiffusionConfig = DiffusionConfig(),
) -> torch.Tensor:
    """Weights from the incoming (seeded) depth, then ``iters`` sweeps on
    the device the tensors live on (``ops/dispatch.py``)."""
    dispatch.check_supported(cfg)
    wts = edge_weights(gray, depth, level, max_level, cfg)
    return dispatch.run_sweeps(depth, mask, wts, abc_schedule(iters, cfg))

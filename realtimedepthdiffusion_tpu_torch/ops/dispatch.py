"""Routing of the per-level sweeps (counterpart of ``realtimedepthdiffusion_tpu/ops/dispatch.py``).

The device of the tensors decides: a CPU tensor runs the plain torch
sweeps, a CUDA tensor runs the hand-written kernels (``ops/sweep.py``).
There is no fallback between the two. What the port does not implement yet
raises, naming the ROADMAP item that will bring it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DiffusionConfig
from . import sweep

VALID_BACKENDS = ("auto", "xla", "pallas", "pallas_interpret")


def check_supported(cfg: DiffusionConfig) -> None:
    """Raise for a config the port cannot solve yet, on every device."""
    if cfg.backend not in VALID_BACKENDS:
        raise ValueError(
            f"unknown backend {cfg.backend!r}; expected one of {VALID_BACKENDS}"
        )
    if cfg.solver != "jacobi_chebyshev":
        raise NotImplementedError(
            f"solver {cfg.solver!r} is not ported yet (ROADMAP A8 and B9); "
            "the port runs 'jacobi_chebyshev'"
        )
    if cfg.early_exit:
        raise NotImplementedError(
            "the residual early exit is not ported yet (ROADMAP A8 and B8)"
        )
    if cfg.multigrid != "cascadic":
        raise NotImplementedError(
            f"multigrid {cfg.multigrid!r} is not ported yet (ROADMAP A9); "
            "the port runs 'cascadic'"
        )


def run_sweeps(depth: torch.Tensor, mask: torch.Tensor, wts, abc: np.ndarray) -> torch.Tensor:
    """All sweeps of one level: the kernels for a CUDA tensor, the plain
    version for a CPU tensor."""
    if depth.is_cuda:
        return sweep.solve_level_cuda(depth, mask, wts, abc)
    if depth.device.type == "cpu":
        return sweep.solve_level_plain(depth, mask, wts, abc)
    raise ValueError(f"unsupported device {depth.device}")

"""Model families: preconfigured solver and multigrid variants of the
depth-diffusion pipeline.

- ``ChebyshevCascade``   the reference algorithm (default)
- ``JacobiCascade``      plain Jacobi smoother
- ``RedBlackCascade``    red-black Gauss-Seidel with the residual early exit
- ``VCycle``             full multigrid V-cycle
"""

from .depth_diffusion import (
    ChebyshevCascade,
    DepthDiffusionModel,
    JacobiCascade,
    RedBlackCascade,
    VCycle,
)

__all__ = [
    "DepthDiffusionModel",
    "ChebyshevCascade",
    "JacobiCascade",
    "RedBlackCascade",
    "VCycle",
]

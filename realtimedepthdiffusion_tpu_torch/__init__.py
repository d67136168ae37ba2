"""PyTorch port of ``realtimedepthdiffusion_tpu`` for an NVIDIA H100.

Layout mirrors the JAX package:

- ``core``     plain torch glue (color, pyramids, annotation, weights, the
               level solve, the cascade, the V-cycle, the windowed
               incremental re-solve, the effects)
- ``ops``      the hand-written CUDA kernels (``csrc/``), their plain torch
               versions, the build, and the routing by device
- ``parallel`` the sharded multi-device step
- ``models``   the task-level facade (numpy in, numpy out)
- ``io``       image and annotation files (Pillow, or PNG by zlib alone)
- ``oracle``   the pure-NumPy reference
- ``utils``    stage timing and profiler traces

It imports torch and numpy, never JAX: a JAX config or state crosses over
through ``interop``.
"""

from .config import DEFAULT_CONFIG, SCRIBBLE_DEPTH_VALUES, DiffusionConfig
from .models import (ChebyshevCascade, DepthDiffusionModel, JacobiCascade, RedBlackCascade,
                     VCycle)
from .pipeline import DepthPipeline, get_pipeline

__version__ = "0.1.0"

__all__ = [
    "DEFAULT_CONFIG",
    "SCRIBBLE_DEPTH_VALUES",
    "DiffusionConfig",
    "DepthPipeline",
    "get_pipeline",
    "DepthDiffusionModel",
    "ChebyshevCascade",
    "JacobiCascade",
    "RedBlackCascade",
    "VCycle",
    "__version__",
]

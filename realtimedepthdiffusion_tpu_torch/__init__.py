"""PyTorch port of ``realtimedepthdiffusion_tpu`` for an NVIDIA H100.

Layout mirrors the JAX package:

- ``core``  plain torch glue (color, pyramids, annotation, weights, the
            level solve, the cascade, the effects)
- ``ops``   the hand-written CUDA kernels (``csrc/``), their plain torch
            versions, the build, and the routing by device

It imports torch and numpy, never JAX: a JAX config or state crosses over
through ``interop``.
"""

from .config import DEFAULT_CONFIG, SCRIBBLE_DEPTH_VALUES, DiffusionConfig
from .pipeline import DepthPipeline, get_pipeline

__version__ = "0.1.0"

__all__ = [
    "DEFAULT_CONFIG",
    "SCRIBBLE_DEPTH_VALUES",
    "DiffusionConfig",
    "DepthPipeline",
    "get_pipeline",
    "__version__",
]

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
through ``interop``. Importing the package itself loads only ``config``;
torch loads with the first name below that needs it, so that the
cold-start bench (``bench_cold``), run as a module of the package, can
time the torch import.
"""

import importlib

from .config import DEFAULT_CONFIG, SCRIBBLE_DEPTH_VALUES, DiffusionConfig

__version__ = "0.1.0"

_LAZY = {
    "DepthPipeline": "pipeline",
    "get_pipeline": "pipeline",
    "DepthDiffusionModel": "models",
    "ChebyshevCascade": "models",
    "JacobiCascade": "models",
    "RedBlackCascade": "models",
    "VCycle": "models",
}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f".{_LAZY[name]}", __name__), name)
    globals()[name] = value
    return value


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

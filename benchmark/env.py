"""The process environment of a benchmark run, set before torch loads.

Every compiler cache a run could use lives at a fixed path inside the
checkout (``benchmark/.cache/``), so that only a checkout's first run
builds. No library may load JAX by itself, and the program's own routing
switches take their defaults (captures on, the build cache in use):
nothing is read from the caller's environment for them.
"""

import os

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(HERE, ".cache")


def prepare() -> None:
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    for knob in ("RTDD_BACKGROUND_COMPILE", "RTDD_FAST_START", "RTDD_NO_COMPILE_CACHE"):
        os.environ.pop(knob, None)
